"""Batched PyTorch inference engine: prefill + greedy decode with a KV
cache — the static path of `repro.serving.engine`.

This is the real-model backend behind the Camel controller: pulling an arm
runs one batch through a model and turns the measured wall time into an
`Observation`.

* **Fused decode** (`decode_impl="fused"`, the default) keeps the whole
  decode loop on the device, the counterpart of the reference's jitted
  `lax.fori_loop`: the greedy argmax runs on the device, tokens go into a
  device `[B, steps]` buffer, and `generate` makes exactly one
  device->host copy.  On CUDA one decode step is captured as a CUDA graph
  per batch size (`DecodeGraph`) and each step is one replay plus the
  token write: the step reads the token, the position and the pad mask
  from static device buffers, so, as the reference's traced `start_pos`,
  a new prompt length replays the same graph.  `decode_impl="loop"`
  copies each token to the host as it is made and runs the step eagerly
  with a Python position — the reference the fused path is held
  bit-identical to.
* **Prompt bucketing** — padded prompt lengths are rounded up to
  `prompt_bucket` multiples, so a sweep over ragged prompts sees one
  prefill shape per (batch, bucket).
* **Cache pool** — one cache per batch size, reused across `generate`
  calls.  The model writes K/V in place, so a pooled cache carries the
  previous call's entries: every position a call reads was written by the
  same call (prefill writes all of [0, L), decode writes `pos` before
  attending to it) or is masked out (positions past `pos`; left-pad
  slots before `kv_start`, ring slots of negative position), so stale
  entries never reach an output.  A recurrent state (rwkv6's, and
  recurrentgemma's `lru_h` and `conv_tail`) is read whole by prefill, so
  a pooled one is zeroed before each prompt: every prefill starts from a
  zero state, as in the reference, whose functional pool is never
  written.

Left-padding batches ragged prompts: all sequences share position indices
and a boolean pad mask (`attn_mask`) keeps pad slots out of attention, so
ragged and unpadded prompts give the same per-sequence logits.

Timing mirrors the reference's `block_until_ready`: on CUDA each clock
read in `generate` follows a `torch.cuda.synchronize()`, so `EngineStats`
holds device time, not launch time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels import launch_counts
from repro_torch.models.registry import ModelBundle
from repro_torch.obs import tracing as obslog
from repro_torch.platform.base import BaseEnvironment, DVFSPlatform
from repro_torch.platform.telemetry import Observation, observe
from repro_torch.serving.queueing import require_positive_rate


@dataclasses.dataclass
class EngineStats:
    prefill_s: float
    decode_s: float
    tokens_out: int
    decode_impl: str = "fused"

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s

    @property
    def tokens_per_s(self) -> float:
        """Decode throughput (generated tokens / decode wall-clock)."""
        return self.tokens_out / self.decode_s if self.decode_s > 0 else 0.0


@contextlib.contextmanager
def _no_host_sync(device: torch.device):
    """On CUDA, make any host sync inside raise
    (`torch.cuda.set_sync_debug_mode("error")`); the previous mode is
    restored on the way out.  Nothing on the CPU."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


class DecodeGraph:
    """The fused path's decode step at one batch size, over that batch's
    pooled cache.  The step reads static device buffers and writes them in
    place: `tok` [B] (the input token, then the greedy argmax), `pos` (a
    0-d int64, advanced by one inside the step) and `mask` [B,
    max_seq_len] (the decode-time pad mask).  On CUDA it is captured once
    as a `torch.cuda.CUDAGraph` and `run` replays it; on the CPU `run`
    calls the same step eagerly.

    `tally` is the kernel launches one replay makes, by counter name
    (`kernels.launch_counts` over the capture, which records each launch
    once); `replays` counts replays, so a replayed run's kernel executions
    are the counters' change plus replays x tally.  `capture_s` is the
    host time of the warm-up and the capture."""

    #: Eager steps on the capture stream before the capture: they load the
    #: kernel libraries and create the stream's cuBLAS handle and
    #: workspace, which a capture must not allocate.
    WARMUP_STEPS = 2

    def __init__(self, engine: "InferenceEngine", batch: int, cache):
        dev = engine.device
        self.bundle, self.params, self.cache = \
            engine.bundle, engine.params, cache
        self.tok = torch.zeros((batch,), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.mask = torch.ones((batch, engine.max_seq_len), dtype=torch.bool,
                               device=dev)
        self.graph = None
        self.tally: Dict[str, int] = {}
        self.replays = 0
        self.capture_s = 0.0
        if dev.type == "cuda":
            self._capture()

    def _step(self) -> None:
        logits, _ = self.bundle.decode_step(self.params, self.tok, self.cache,
                                            self.pos, attn_mask=self.mask)
        self.tok.copy_(torch.argmax(logits, dim=-1))
        self.pos.add_(1)

    def _capture(self) -> None:
        """Warm up on a side stream, then capture one step on it, each
        under `_no_host_sync`: a step that syncs raises here.  The warm-up
        writes the cache (K/V at slots 0 and 1, the recurrent state); the
        caller zeroes the state before the next prefill, and K/V slots are
        rewritten or masked as for any pooled cache."""
        dev = self.tok.device
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream), _no_host_sync(dev):
            for _ in range(self.WARMUP_STEPS):
                self._step()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            with _no_host_sync(dev):
                self._step()
        after = launch_counts()
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        self.tally = {k: after[k] - before[k] for k in after}
        self.graph = graph
        self.capture_s = time.monotonic() - t0

    def run(self) -> None:
        """One decode step: a replay on CUDA, the eager step on the CPU."""
        if self.graph is None:
            self._step()
        else:
            self.graph.replay()
            self.replays += 1


class InferenceEngine:
    """Greedy batched generation: one prefill, then `max_new_tokens`
    decode steps.

    decode_impl: "fused" (device-side token buffer, one host copy per
    generate; on CUDA a graph replay a step) or "loop" (a host copy per
    token, eager steps).  A fused step that cannot be captured raises:
    nothing falls back to eager decode.  prompt_bucket: padded
    prompt lengths are rounded up to this multiple.  device: where the
    engine's inputs and caches live (CUDA unless told otherwise); `params`
    must already be there.
    """

    def __init__(self, bundle: ModelBundle, params, max_batch: int,
                 max_seq_len: int, pad_id: int = 0,
                 decode_impl: str = "fused", prompt_bucket: int = 16,
                 device=None):
        if decode_impl not in ("fused", "loop"):
            raise ValueError(f"decode_impl must be 'fused' or 'loop', "
                             f"got {decode_impl!r}")
        if prompt_bucket < 1:
            raise ValueError(f"prompt_bucket must be >= 1, "
                             f"got {prompt_bucket}")
        self.device = resolve_device(device)
        self.bundle = bundle
        self.params = params
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.pad_id = pad_id
        self.decode_impl = decode_impl
        self.prompt_bucket = prompt_bucket
        self._cache_pool: Dict[int, object] = {}
        # batch -> the fused path's decode step over that batch's cache
        self.decode_graphs: Dict[int, DecodeGraph] = {}
        # (entry point, batch, bucketed prompt length) -> calls
        self.calls: collections.Counter = collections.Counter()

    # -- shape management --------------------------------------------------

    def _bucket_len(self, n: int) -> int:
        bkt = self.prompt_bucket
        return ((n + bkt - 1) // bkt) * bkt

    def _pad_batch(self, prompts: List[np.ndarray],
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Left-pad to the bucketed max length.
        Returns (tokens [B, L], pad mask [B, L] (True = real), L)."""
        b = len(prompts)
        plen = self._bucket_len(max(len(p) for p in prompts))
        out = np.full((b, plen), self.pad_id, np.int64)
        mask = np.zeros((b, plen), bool)
        for i, p in enumerate(prompts):
            out[i, plen - len(p):] = p       # left padding
            mask[i, plen - len(p):] = True
        return out, mask, plen

    def _cache_for(self, batch: int):
        cache = self._cache_pool.get(batch)
        if cache is None:
            cache = self.bundle.init_cache(batch, self.max_seq_len,
                                           self.device)
            self._cache_pool[batch] = cache
        else:
            self.bundle.zero_state(cache)
        return cache

    def _graph_for(self, batch: int, cache) -> DecodeGraph:
        """The fused decode step at `batch`, captured on first use (before
        the prefill: the capture's warm-up writes the state, which is
        zeroed again here).  A failed capture raises and stores nothing."""
        graph = self.decode_graphs.get(batch)
        if graph is None:
            graph = DecodeGraph(self, batch, cache)
            self.bundle.zero_state(cache)
            self.decode_graphs[batch] = graph
        return graph

    @property
    def compile_counts(self) -> Dict[str, int]:
        """The torch meaning of the reference's jit-cache sizes, plus the
        cache pool size.  "decode_fused": the decode steps the fused path
        holds, one a batch size — CUDA graphs captured on CUDA, batch
        sizes run on the CPU — which, for a fixed `max_new_tokens`,
        equals the reference's count (its `start_pos` is traced).
        "prefill" and "decode_loop": the distinct (batch, bucketed prompt
        length) shapes each has run.  A sweep that repeats shapes keeps
        these flat; `calls` has the call count per shape."""
        counts = {"prefill": 0, "decode_loop": 0}
        for (entry, _, _) in self.calls:
            if entry in counts:
                counts[entry] += 1
        counts["decode_fused"] = len(self.decode_graphs)
        counts["cache_pool"] = len(self._cache_pool)
        return counts

    # -- generation --------------------------------------------------------

    def _validate(self, prompts: List[np.ndarray], max_new_tokens: int,
                  ) -> None:
        if not prompts:
            raise ValueError("generate() needs at least one prompt")
        if any(len(p) == 0 for p in prompts):
            raise ValueError("generate() got an empty prompt")
        if len(prompts) > self.max_batch:
            raise ValueError(
                f"batch of {len(prompts)} prompts exceeds max_batch="
                f"{self.max_batch}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        plen = self._bucket_len(max(len(p) for p in prompts))
        if plen + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"bucketed prompt length {plen} + max_new_tokens "
                f"{max_new_tokens} exceeds max_seq_len={self.max_seq_len} "
                f"(the KV cache would overrun)")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, prompts: List[np.ndarray], max_new_tokens: int,
                 ) -> Tuple[np.ndarray, EngineStats]:
        """Greedy-decode `max_new_tokens` for each prompt.
        Returns (tokens [B, max_new_tokens] int32, stats)."""
        self._validate(prompts, max_new_tokens)
        toks, mask, prompt_len = self._pad_batch(prompts)
        b = toks.shape[0]
        cache = self._cache_for(b)
        graph = self._graph_for(b, cache) \
            if self.decode_impl == "fused" else None
        dev = self.device

        self._sync()
        t0 = time.monotonic()
        mask_d = torch.from_numpy(mask).to(dev)
        logits, cache = self.bundle.prefill(
            self.params, torch.from_numpy(toks).to(dev), cache,
            attn_mask=mask_d)
        self.calls["prefill", b, prompt_len] += 1
        tok = torch.argmax(logits, dim=-1)
        self._sync()
        t_prefill = time.monotonic() - t0

        # Decode-time pad mask over global positions: prompt pads stay
        # invalid, every decode-written slot (>= prompt_len) is valid.
        dec_mask = torch.ones((b, self.max_seq_len), dtype=torch.bool,
                              device=dev)
        dec_mask[:, :prompt_len] = mask_d
        key = ("decode_fused" if self.decode_impl == "fused"
               else "decode_loop", b, prompt_len)
        t0 = time.monotonic()
        if graph is not None:
            graph.mask.copy_(dec_mask)
            graph.tok.copy_(tok)
            graph.pos.fill_(prompt_len)      # the step advances it
            out_d = torch.empty((b, max_new_tokens), dtype=torch.int32,
                                device=dev)
            with _no_host_sync(dev):
                for i in range(max_new_tokens):
                    out_d[:, i] = graph.tok
                    graph.run()
            out = out_d.cpu().numpy()        # the one device->host copy
        else:
            out = np.zeros((b, max_new_tokens), np.int32)
            for i in range(max_new_tokens):
                out[:, i] = tok.cpu().numpy()
                logits, cache = self.bundle.decode_step(
                    self.params, tok, cache, prompt_len + i,
                    attn_mask=dec_mask)
                tok = torch.argmax(logits, dim=-1)
        self._sync()
        t_decode = time.monotonic() - t0
        self.calls[key] += 1

        st = EngineStats(prefill_s=t_prefill, decode_s=t_decode,
                         tokens_out=b * max_new_tokens,
                         decode_impl=self.decode_impl)
        if obslog.active():
            obslog.emit("engine.prefill", dur_s=t_prefill, batch=b,
                        prompt_len=prompt_len)
            obslog.emit("engine.decode", dur_s=t_decode, batch=b,
                        tokens=st.tokens_out,
                        decode_impl=self.decode_impl,
                        tokens_per_s=st.tokens_per_s or None)
        return out, st


class EngineEnvironment(BaseEnvironment):
    """Camel Environment backed by the real engine: pulling an arm serves
    one batch of synthetic prompts at that batch size and converts the
    measured wall time into an `Observation`.  Power is the analytical
    board model (the reference's `sensor=None` path) evaluated at the
    arm's level and utilization, and the measured time is scaled from the
    top level to the arm's by the workload's frequency factor.  Registry
    name: "engine/<arch>"."""

    def __init__(self, engine: InferenceEngine, board, work,
                 arrival_rate: float = 1.0, prompt_len: int = 32,
                 max_new_tokens: int = 16, seed: int = 0):
        self.engine = engine
        self.board = board
        self.work = work
        self.platform = DVFSPlatform(board)
        self.arrival_rate = require_positive_rate(arrival_rate)
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.rng = np.random.default_rng(seed)

    def pull(self, knobs: Dict, round_index: int) -> Observation:
        batch = int(knobs["batch"])
        level = self.platform.level_of(knobs["freq_mhz"])
        self.platform.set_level(level)
        util = self.work.utilization(batch)
        vocab = self.engine.bundle.cfg.vocab_size
        prompts = [self.rng.integers(1, vocab, size=self.prompt_len)
                   .astype(np.int32) for _ in range(batch)]
        _, st = self.engine.generate(prompts, self.max_new_tokens)

        factor = self.work.freq_factor(self.board, level) \
            / self.work.freq_factor(self.board, self.board.n_levels - 1)
        t_batch = st.total_s * factor
        p = self.board.power(level, util)
        metadata = {"backend": "engine", "prefill_s": st.prefill_s,
                    "decode_s": st.decode_s,
                    "decode_impl": st.decode_impl,
                    "tokens_per_s": st.tokens_per_s}
        # Single-batch horizon (n_requests = batch): no saturation backlog.
        return observe(p, t_batch, batch, self.arrival_rate,
                       n_requests=batch, tokens=st.tokens_out,
                       metadata=metadata)
