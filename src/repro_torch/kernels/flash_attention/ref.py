"""Plain PyTorch prefill attention: the CPU path of `ops.flash_attention`
and the oracle its CUDA kernel is held to on the card.

The arithmetic of `repro.kernels.flash_attention.ref.attention_ref`
(causal, sliding window, tanh softcap, GQA, fp32 softmax) plus the port's
per-row `kv_start`: keys before it are invalid (the left-pad prefix of
`models/flash.py`'s `kv_valid`), except the first `prefix_len` keys of a
row, which stay valid (prefix embeddings placed before the pads: a row's
valid keys are [0, prefix_len) and [kv_start, Sk)).  Weights of invalid
keys are selected to exactly 0, so a query row with no valid key — a
left-pad row — is 0, finite, as the kernel writes it.

`row_scaled_error` is the tolerance measure the kernel is held to on the
card: each query row (one head's D outputs at one position) against that
row's own max |ref|.  Over thousands of keys a row's outputs are small
(RMS ~1/sqrt(keys)) while a row over one key is a value row of magnitude
~3, so a bound scaled by the whole output's max, or an absolute one, would
pass a result that lost a whole tile of keys in late rows."""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q, k, v, *, scale: Optional[float] = None,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0,
                  kv_start: Optional[torch.Tensor] = None,
                  prefix_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B, Sq, H, D]; k/v: [B, Sk, KVH, D]; kv_start, prefix_len:
    optional [B] int -> [B, Sq, H, D] in q's dtype."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = (q.float() * scale).reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window > 0:
        mask = mask & (kpos > qpos - window)
    mask = mask[None].expand(b, sq, sk)
    if kv_start is not None:
        start = kv_start.to(device=q.device, dtype=torch.long)
        valid = kpos[None] >= start[:, None, None]
        if prefix_len is not None:
            pre = prefix_len.to(device=q.device, dtype=torch.long)
            valid = valid | (kpos[None] < pre[:, None, None])
        mask = mask & valid
    mask = mask[:, None, None]                      # [B, 1, 1, Sq, Sk]
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.where(mask, torch.softmax(s, dim=-1), torch.zeros_like(s))
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)


def row_scaled_error(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max over query rows of max |out - ref| / max |ref| of that row, a row
    being the last dim (one head's D values at one position).  A row whose
    reference is all zeros (no valid key) passes only where `out` is zero
    too."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    err = (o - r).abs().amax(dim=1)
    return float((err / r.abs().amax(dim=1).clamp_min(1e-30)).max())
