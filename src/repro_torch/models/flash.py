"""Blocked (flash) attention in plain PyTorch: a loop over KV blocks with an
online softmax, so only block-sized score tensors materialize.

The port of `repro.models.flash`, kept as the algorithmic reference for
prefill attention: the engine's prefill runs the CUDA kernel through
`kernels/flash_attention/ops.py`, and the tests hold this function to the
JAX one on every row and the kernel's plain version to it on every valid
row.  Semantics are the reference's to the letter, including its value for
a query row with no valid key (a left-pad row): with every score at the
-1e30 sentinel each block's weights are exp(0) = 1, so such a row is the
mean of the values — finite, thanks to the sentinel and the
``max(l, 1e-30)`` guard.  (The kernel writes 0 there instead; no valid row
ever reads a pad row.)

Supports: causal masking, sliding window, logit soft-cap, GQA and
per-sequence key validity (`kv_valid`).  The reference's query offset and
per-call window override serve no caller of the port and are left out.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.common import AttnSpec

_NEG = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    spec: AttnSpec, causal: bool = True,
                    block_kv: int = 512,
                    kv_valid: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q: [B,Sq,H,D], k/v: [B,Sk,KVH,D] -> [B,Sq,H*D].  `kv_valid`
    ([B, Sk] bool, True = attend) masks out per-sequence key slots."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = spec.query_scale if spec.query_scale is not None \
        else 1.0 / math.sqrt(hd)
    dev = q.device

    blk = min(block_kv, sk)
    nblk = -(-sk // blk)
    pad = nblk * blk - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_valid is not None:
            kv_valid = torch.nn.functional.pad(kv_valid, (0, pad))
    if kv_valid is None:
        kv_valid = torch.ones((b, nblk * blk), dtype=torch.bool, device=dev)

    qg = (q.float() * scale).reshape(b, sq, kvh, g, hd)
    qpos = torch.arange(sq, device=dev)                        # [Sq]
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32, device=dev)
    m_run = torch.full((b, kvh, g, sq), _NEG, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=dev)
    for i in range(nblk):
        sl = slice(i * blk, (i + 1) * blk)
        kc, vc, valid = k[:, sl].float(), v[:, sl].float(), kv_valid[:, sl]
        kpos = i * blk + torch.arange(blk, device=dev)         # [blk]

        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kc)
        if spec.logit_softcap > 0.0:
            cap = spec.logit_softcap
            s = cap * torch.tanh(s / cap)
        mask = (kpos[None, :] < sk).expand(sq, blk)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if spec.sliding_window > 0:
            mask = mask & (kpos[None, :] > qpos[:, None]
                           - spec.sliding_window)
        full = mask[None, None, None] & valid[:, None, None, None, :]
        s = torch.where(full, s, torch.full_like(s, _NEG))

        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vc)
        m_run = m_new

    out = acc / l_run[..., None].clamp_min(1e-30)               # [B,KV,G,Sq,D]
    out = out.permute(0, 3, 1, 2, 4)                           # [B,Sq,KV,G,D]
    return out.reshape(b, sq, h * hd).to(q.dtype)
