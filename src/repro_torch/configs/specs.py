"""Dry-run input specifications of the port, the counterpart of
`repro.configs.specs`: the step functions' inputs as tensors on the meta
device (shape and dtype, no memory), where the reference has
`jax.ShapeDtypeStruct`s.

Each architecture pairs with four shapes:
    train_4k     seq 4096  x global_batch 256   -> train_step
    prefill_32k  seq 32768 x global_batch 32    -> prefill_step
    decode_32k   KV 32768  x global_batch 128   -> serve_step (1 new token)
    long_500k    KV 524288 x global_batch 1     -> serve_step; sub-quadratic
                                                   archs only
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

SHAPES: Dict[str, tuple] = {
    "train_4k": (4096, 256),
    "prefill_32k": (32768, 32),
    "decode_32k": (32768, 128),
    "long_500k": (524288, 1),
}

#: archs that run the 500k decode cell (attention-free / windowed / hybrid)
LONG_OK = {"rwkv6-3b", "recurrentgemma-9b", "gemma2-27b", "mixtral-8x22b"}


@dataclasses.dataclass(frozen=True)
class DryRunSpec:
    kind: str                      # "train" | "prefill" | "decode"
    inputs: Dict[str, Any]         # step-fn inputs as meta tensors
    batch: int
    seq_len: int
    note: str = ""


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def lm_input_specs(cfg, shape: str, *, prefix_len: int = 0,
                   dtype=torch.bfloat16) -> Optional[DryRunSpec]:
    """Decoder-only LM families (transformer / rwkv6 / rglru)."""
    if shape not in SHAPES:
        raise KeyError(shape)
    seq, gb = SHAPES[shape]
    if shape == "long_500k" and cfg.name not in LONG_OK:
        return None

    if shape in ("train_4k", "prefill_32k"):
        inputs = {"tokens": _meta((gb, seq), torch.int32)}
        if shape == "train_4k":
            inputs["labels"] = _meta((gb, seq), torch.int32)
        if prefix_len:
            inputs["prefix_embeddings"] = _meta((gb, prefix_len,
                                                 cfg.d_model), dtype)
        kind = "train" if shape == "train_4k" else "prefill"
        return DryRunSpec(kind, inputs, gb, seq)

    # decode shapes: one token against a seq-long cache
    inputs = {"token": _meta((gb,), torch.int32),
              "pos": _meta((), torch.int32)}
    return DryRunSpec("decode", inputs, gb, seq)


def encdec_input_specs(cfg, shape: str, *, dtype=torch.bfloat16,
                       ) -> Optional[DryRunSpec]:
    """seamless: encoder memory capped at cfg.max_source_len frames; the
    sequence axis of the decode shapes applies to the decoder target."""
    seq, gb = SHAPES[shape]
    if shape == "long_500k":
        return None  # full-attention enc-dec: skipped
    src = min(seq, cfg.max_source_len)

    if shape == "train_4k":
        return DryRunSpec("train", {
            "speech_embeddings": _meta((gb, src, cfg.d_model), dtype),
            "tokens": _meta((gb, seq), torch.int32),
            "labels": _meta((gb, seq), torch.int32)}, gb, seq)

    if shape == "prefill_32k":
        return DryRunSpec("prefill", {
            "speech_embeddings": _meta((gb, src, cfg.d_model), dtype),
            "tokens": _meta((gb, seq), torch.int32)}, gb, seq,
            note=f"encoder memory capped at {src} frames")

    return DryRunSpec("decode", {
        "token": _meta((gb,), torch.int32),
        "pos": _meta((), torch.int32)}, gb, seq)
