"""Plain PyTorch decode attention: the CPU path of `ops.decode_attention`
and the oracle its CUDA kernel is held to on the card, and the split
kernel's two-pass algebra (`decode_attention_split_ref`).  The arithmetic of
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


def decode_attention_split_ref(q, k, v, kv_len, kv_start=None, *,
                               n_splits: int, split_len: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """The CUDA kernel's two passes in plain PyTorch.  Split i takes the
    keys [i * split_len, (i + 1) * split_len) inside the window and gives
    a partial (m, l, acc): its max score, its sum of exp(score - m) and
    the weighted sum of its values (m = -1e30, l = 0, acc = 0 for a split
    with no valid key).  The partials are merged in split order, and a
    row whose total l is 0 gets 0.  Same arguments and result as
    `decode_attention_ref`."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = (q.float() * scale).reshape(b, kvh, h // kvh, d)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    ends = rows_i32(kv_len, b, q.device)
    starts = rows_i32(0 if kv_start is None else kv_start, b, q.device)
    idx = torch.arange(s, device=q.device)[None, :]
    window = (idx < ends[:, None]) & (idx >= starts[:, None])
    parts = []
    for i in range(n_splits):
        keys = slice(i * split_len, min(s, (i + 1) * split_len))
        mask = window[:, None, None, keys]
        si = torch.where(mask, sc[..., keys], torch.full_like(sc[..., keys],
                                                              -1e30))
        m = si.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(si - m), torch.zeros_like(si))
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      torch.einsum("bkgs,bskd->bkgd", p, v[:, keys].float())))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_all = torch.zeros_like(m_all)
    acc = torch.zeros((b, kvh, h // kvh, d), dtype=torch.float32,
                      device=q.device)
    for m, l, a in parts:
        f = torch.exp(m - m_all)
        l_all = l_all + f * l
        acc = acc + f * a
    o = torch.where(l_all > 0, acc / torch.where(l_all > 0, l_all, 1.0),
                    torch.zeros_like(acc))
    return o.reshape(b, h, d).to(q.dtype)
