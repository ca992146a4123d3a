"""Entry point of prefill attention: `flash_attention(q, k, v, scale=,
causal=, window=, softcap=, kv_start=)`, the signature of
`repro.kernels.flash_attention.ops.flash_attention` without its TPU-only
`block_q` / `block_kv` / `interpret` arguments, plus the per-row
`kv_start` the engine's left-padded prefill needs.

Kernel: `repro_torch/csrc/flash_attention.cu`, which replaces the Pallas
`_fwd_kernel` (src/repro/kernels/flash_attention/flash_attention.py:38).
It reads q/k/v in [B, S, H, D] in place.  A CPU tensor takes the plain
version in `ref.py`; a CUDA tensor launches the kernel or raises.
`launches` counts kernel launches."""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import rows_i32
from repro_torch.kernels.flash_attention.ref import attention_ref

#: Kernel launches made through `flash_attention` (CPU path excluded).
launches = 0

#: Query heads one CTA can hold per KV head (8 warps x 8 pairs).
MAX_GROUP = 64


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    kv_start: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q: [B, Sq, H, D]; k/v: [B, Sk, KVH, D] (any batch/seq/head strides,
    unit last-dim stride); kv_start: optional [B] first valid key per row.
    Returns [B, Sq, H, D] (contiguous) in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale=scale, causal=causal,
                             window=window, softcap=softcap,
                             kv_start=kv_start)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must share one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k/v must be [B,Sk,KVH,D] with "
                         f"B={b}, D={d}; got {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share a dtype")
    if h % kvh or not 1 <= h // kvh <= MAX_GROUP:
        raise ValueError(f"flash_attention: H={h} must be a multiple of "
                         f"KVH={kvh} with at most {MAX_GROUP} heads a group")
    if d not in (32, 64, 96, 128):
        raise ValueError(f"flash_attention: head_dim {d} not in "
                         "(32, 64, 96, 128)")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: q, k, v need unit last-dim "
                         "strides")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    starts = None if kv_start is None else rows_i32(kv_start, b, q.device)
    code = _build.dtype_code(q)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    err = _build.load("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if starts is None else starts.data_ptr(),
        code, b, sq, sk, h, kvh, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), int(window), float(softcap), float(scale),
        _build.stream())
    _build.check("flash_attention", err)
    launches += 1
    return out
