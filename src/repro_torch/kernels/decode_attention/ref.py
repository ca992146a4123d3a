"""Plain PyTorch decode attention: the CPU path of `ops.decode_attention`
and the oracle its CUDA kernel is held to on the card.  The arithmetic of
`repro.kernels.decode_attention.ref.decode_attention_ref`, except that the
weights of keys outside the window are selected to exactly 0 — identical
whenever the window holds a key, and 0 (not an average of masked rows)
when it holds none, as the kernel gives."""

from __future__ import annotations

import math
from typing import Optional

import torch


def rows_i32(value, b: int, device) -> torch.Tensor:
    """A scalar or [B] window bound as an int32 [B] tensor on `device`."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.int32).expand(b) \
            .contiguous()
    return torch.full((b,), int(value), dtype=torch.int32, device=device)


def decode_attention_ref(q, k, v, kv_len, kv_start=None, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, H, D]; k/v: [B, S, KVH, D]; kv_len scalar or [B] (exclusive
    end); kv_start optional scalar or [B] (inclusive start) -> [B, H, D]."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = (q.float() * scale).reshape(b, kvh, g, d)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    ends = rows_i32(kv_len, b, q.device)
    starts = rows_i32(0 if kv_start is None else kv_start, b, q.device)
    idx = torch.arange(s, device=q.device)[None, :]
    mask = ((idx < ends[:, None]) & (idx >= starts[:, None]))[:, None, None]
    sc = torch.where(mask, sc, torch.full_like(sc, -1e30))
    p = torch.where(mask, torch.softmax(sc, dim=-1), torch.zeros_like(sc))
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(b, h, d).to(q.dtype)
