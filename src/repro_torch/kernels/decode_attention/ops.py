"""Entry point of decode attention: `decode_attention(q, k, v, kv_len,
kv_start=None, scale=)`, the signature of
`repro.kernels.decode_attention.ops.decode_attention` without its TPU-only
`block_kv` / `interpret` arguments.

Kernel: `repro_torch/csrc/decode_attention.cu`, which replaces the Pallas
`_decode_kernel` (src/repro/kernels/decode_attention/decode_attention.py:32).
It reads the cache in place through its strides and splits the KV axis
across CTAs (`split_plan`); with more than one split a second kernel merges
the partials.  A CPU tensor takes the plain version in `ref.py`; a CUDA
tensor launches the kernels or raises.  `launches` counts calls that
launched the split kernel, `combine_launches` those that also launched the
combine kernel."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch._device import SM_COUNT, sm_count
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, rows_i32)

#: Split-kernel launches made through `decode_attention` (CPU path excluded).
launches = 0
#: Combine-kernel launches (calls with more than one split).
combine_launches = 0

#: Query heads one call takes per KV head (a CTA holds 8; larger groups
#: take more CTAs).
MAX_GROUP = 32
#: Least keys a split holds, and the granule of a split's length.
MIN_SPLIT_KEYS = 256
SPLIT_GRANULE = 64


def split_plan(b: int, kvh: int, s: int,
               sms: int = SM_COUNT) -> Tuple[int, int]:
    """(n_splits, split_len) for a batch of `b` rows over a cache of `s`
    slots and `kvh` KV heads on a card of `sms` SMs, from these shapes
    alone (never from the window bounds, which live on the device).  One
    split up to 256 slots; else the most splits of at least 256 keys (a
    multiple of 64) whose B * KVH * n_splits CTAs fit two to an SM: two
    waves with no partial third, which on the H100 ran faster than more
    splits that left some SMs a third CTA."""
    if s <= MIN_SPLIT_KEYS:
        return 1, s
    want = min(2 * sms // (b * kvh), s // MIN_SPLIT_KEYS)
    if want <= 1:
        return 1, s
    length = -(-s // want)
    length = -(-length // SPLIT_GRANULE) * SPLIT_GRANULE
    return -(-s // length), length


def decode_attention(q, k, v, kv_len, kv_start=None, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention over a KV cache.

    q: [B, H, D]; k/v: [B, S, KVH, D] (any batch/seq/head strides, unit
    last-dim stride); kv_len (scalar or [B]) is the exclusive end of the
    valid window, kv_start (optional, scalar or [B]) its inclusive start.
    Returns [B, H, D] in q's dtype."""
    global launches, combine_launches
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, kv_len, kv_start, scale=scale)
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError("decode_attention: q, k, v must share one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if k.shape != (b, s, kvh, d) or v.shape != k.shape:
        raise ValueError(f"decode_attention: k/v must be [B,S,KVH,D] = "
                         f"{(b, s, kvh, d)}, got {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_attention: q, k, v must share a dtype")
    if h % kvh or not 1 <= h // kvh <= MAX_GROUP:
        raise ValueError(f"decode_attention: H={h} must be a multiple of "
                         f"KVH={kvh} with at most {MAX_GROUP} heads a group")
    if d not in (32, 64, 96, 128):
        raise ValueError(f"decode_attention: head_dim {d} not in "
                         "(32, 64, 96, 128)")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1 \
            or q.stride(1) != d:
        raise ValueError("decode_attention: q must have [B, H, D] rows "
                         "with unit last-dim strides for q, k, v")
    e = k.element_size()
    if any(t.data_ptr() % 16 or any(st * e % 16 for st in t.stride()[:3])
           for t in (k, v)):
        raise ValueError("decode_attention: k and v must start on 16 bytes "
                         "with batch, slot and head strides of whole 16-byte"
                         " vectors (the kernel copies 16-byte vectors)")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    lens = rows_i32(kv_len, b, q.device)
    starts = None if kv_start is None else rows_i32(kv_start, b, q.device)
    code = _build.dtype_code(q)
    n_splits, split_len = split_plan(b, kvh, s, sm_count(q.device))
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    part = None if n_splits == 1 else torch.empty(
        (b, h, n_splits, d + 2), dtype=torch.float32, device=q.device)
    err = _build.load("decode_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        lens.data_ptr(), None if starts is None else starts.data_ptr(),
        code, b, h, kvh, d, s, n_splits, split_len,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(scale), _build.stream())
    _build.check("decode_attention", err)
    launches += 1
    combine_launches += n_splits > 1
    return out
