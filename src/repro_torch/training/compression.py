"""Gradient compression, the port of `repro.training.compression`: int8
block quantization with error feedback.

Gradients are quantized to int8 in blocks of BLOCK values with one fp32
scale a block (the block's max |value| / 127, codes rounded half to even,
as `jnp.round` rounds), and the quantization residual is fed back into the
next step's gradient, so the compression is unbiased over time (Seide et
al., 1-bit SGD lineage; EF21).  The codes and scales are the reference's
bit for bit.  The port trains on one card, where no all-reduce crosses the
wire; `compressed_grads` is the transform a train step applies
(`launch/steps.py`, `compress_grads`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.training import tree as tree_mod

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    n = x.numel()
    flat = x.reshape(-1).to(torch.float32)
    pad = (-n) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, BLOCK), n


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) -> (int8 codes [nb, BLOCK], fp32 scales [nb])."""
    blocks, _ = _pad_to_block(x)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127
                        ).to(torch.int8)
    return codes, scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor, shape,
               dtype=torch.float32) -> torch.Tensor:
    flat = (codes.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(shape).to(dtype)


def roundtrip(x: torch.Tensor) -> torch.Tensor:
    codes, scale = quantize(x)
    return dequantize(codes, scale, x.shape, x.dtype)


def init_error_state(grads: Any) -> Any:
    return tree_mod.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads)


def compressed_grads(grads: Any, error_state: Any) -> Tuple[Any, Any]:
    """Error-feedback int8 compression of a gradient tree.  Returns
    (compressed-then-decompressed grads, new error state)."""
    flat_g = tree_mod.leaves(grads)
    flat_e = tree_mod.leaves(error_state)
    qs, es = [], []
    for g, e in zip(flat_g, flat_e):
        gf = g.to(torch.float32) + e
        q = roundtrip(gf)
        qs.append(q)
        es.append(gf - q)
    return tree_mod.unflatten(grads, qs), tree_mod.unflatten(grads, es)


@dataclasses.dataclass(frozen=True)
class CompressionStats:
    raw_bytes: int
    compressed_bytes: int

    @property
    def ratio(self) -> float:
        return self.raw_bytes / max(self.compressed_bytes, 1)


def stats(grads: Any) -> CompressionStats:
    flat = tree_mod.leaves(grads)
    raw = sum(g.numel() * 4 for g in flat)
    comp = sum(g.numel() * 1 + (g.numel() // BLOCK + 1) * 4 for g in flat)
    return CompressionStats(raw_bytes=raw, compressed_bytes=comp)
