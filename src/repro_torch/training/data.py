"""Deterministic synthetic data pipeline, the port of
`repro.training.data`.

`batch(step)` is a pure function of (seed, step): it draws from a CPU
`torch.Generator` seeded from the pair, so every host can make exactly its
shard without communication, the same batch comes out whatever device
trains on it, and the stream resumes from a step index alone (the
pipeline's checkpoint state is just `step`).  The distribution is the
reference's: Zipfian tokens and EOS resets at rate 1 / mean_doc_len
("documents" of varying length).  The random stream is torch's, so the
batches match the reference's in distribution, not draw for draw.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2          # Zipf exponent for token frequencies
    mean_doc_len: int = 256
    eos_id: int = 0


def _stream_seed(seed: int, step: int) -> int:
    """A generator seed for (seed, step), mixed so neighbouring steps and
    seeds draw unrelated streams."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return int(state[0]) & ((1 << 63) - 1)


class SyntheticLM:
    """Counter-based synthetic LM stream: batch(step) is a pure function."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # The reference's closed-form Zipf rank distribution, once.
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / np.power(ranks, cfg.zipf_a)
        probs /= probs.sum()
        self._probs = torch.from_numpy(probs)
        self._logits = torch.from_numpy(np.log(probs).astype(np.float32))

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Global batch for `step`: {'tokens': [B,S], 'labels': [B,S]},
        int32 on the CPU."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(_stream_seed(cfg.seed, step))
        n = cfg.global_batch * (cfg.seq_len + 1)
        toks = torch.multinomial(self._probs, n, replacement=True,
                                 generator=gen)
        toks = toks.view(cfg.global_batch, cfg.seq_len + 1)
        # EOS resets with rate 1/mean_doc_len
        eos = torch.rand(toks.shape, generator=gen, dtype=torch.float64) \
            < 1.0 / cfg.mean_doc_len
        toks = torch.where(eos, cfg.eos_id, toks).to(torch.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def host_shard(self, step: int, host_index: int, n_hosts: int,
                   ) -> Dict[str, torch.Tensor]:
        """Per-host slice of the global batch (no cross-host comms)."""
        b = self.batch(step)
        per = self.cfg.global_batch // n_hosts
        sl = slice(host_index * per, (host_index + 1) * per)
        return {k: v[sl] for k, v in b.items()}

    def iterate(self, start_step: int = 0
                ) -> Iterator[Dict[str, torch.Tensor]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
