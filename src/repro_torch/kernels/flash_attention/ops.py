"""Entry point of prefill attention: `flash_attention(q, k, v, scale=,
causal=, window=, softcap=, kv_start=)`, the signature of
`repro.kernels.flash_attention.ops.flash_attention` without its TPU-only
`block_q` / `block_kv` / `interpret` arguments, plus the per-row
`kv_start` the engine's left-padded prefill needs and the per-row
`prefix_len` of a prefix placed before the pads: a row's valid keys are
[0, prefix_len) and [kv_start, Sk).  The kernels skip the key tiles of the
pad gap between the two, and `prefix_len=None` launches exactly what a
call without it did.

Kernels: `repro_torch/csrc/flash_attention.cu`, which replaces the Pallas
`_fwd_kernel` (src/repro/kernels/flash_attention/flash_attention.py:38,
call :134).  It reads q/k/v in [B, S, H, D] in place.  `route` picks the
kernel from the dtype alone, and nothing falls back:

- bf16 -> "tc": `flash_attention_wgmma`, on the tensor cores.  TMA streams
  K/V tiles of 64-128 keys into shared memory, wgmma computes q k^T and
  P v with fp32 accumulators, the online softmax runs in registers, and
  the G query heads of a KV head are packed into one 64-row tile.  On the
  H100 the 28 x 16-token prefills of the engine are bound by launch
  latency (~0.1 GFLOP, ~2 MB); at 4 x 4000 tokens by operations (2.6e11
  for llama's heads: 0.265 ms at 989 TFLOP/s), where at head_dim 64 the
  softmax's instructions cost as much time as the products.
- fp32 -> "simt": the CUDA-core kernel (attention.cuh), which the fp32
  model checks need: the tensor cores' fp32 mode (TF32) would miss their
  2e-5.

A CPU tensor takes the plain version in `ref.py`; a CUDA tensor launches
one of the two kernels or raises.  `launches` counts kernel launches,
`tc_launches` those of the tensor-core route."""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import rows_i32
from repro_torch.kernels.flash_attention.ref import attention_ref

#: Kernel launches made through `flash_attention` (CPU path excluded).
launches = 0
#: Of those, launches of the tensor-core (bf16) kernel.
tc_launches = 0

#: Query heads a call takes per KV head.
MAX_GROUP = 64
#: Head dims both kernels take.
HEAD_DIMS = (32, 64, 96, 128, 256)
#: The kernel of each dtype, and its C entry point.
ROUTES = {torch.bfloat16: "tc", torch.float32: "simt"}
_ENTRY = {"tc": "flash_attention_tc_launch",
          "simt": "flash_attention_launch"}


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes `dtype` at `head_dim`: "tc" (bf16, tensor
    cores) or "simt" (fp32, CUDA cores).  Raises for anything else."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {head_dim} not in "
                         f"{HEAD_DIMS}")
    try:
        return ROUTES[dtype]
    except KeyError:
        raise TypeError("flash_attention kernels take bfloat16 or float32, "
                        f"got {dtype}") from None


def flash_attention(q, k, v, *, scale: Optional[float] = None,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0,
                    kv_start: Optional[torch.Tensor] = None,
                    prefix_len: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """q: [B, Sq, H, D]; k/v: [B, Sk, KVH, D] (any batch/seq/head strides,
    unit last-dim stride; in bf16 the bases and strides 16-byte aligned);
    kv_start: optional [B] first valid key per row after its pads;
    prefix_len: optional [B] keys valid before the pads.  Returns
    [B, Sq, H, D] (contiguous) in q's dtype."""
    global launches, tc_launches
    if q.device.type == "cpu":
        return attention_ref(q, k, v, scale=scale, causal=causal,
                             window=window, softcap=softcap,
                             kv_start=kv_start, prefix_len=prefix_len)
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
    kind = route(q.dtype, d)
    if h % kvh or not 1 <= h // kvh <= MAX_GROUP:
        raise ValueError(f"flash_attention: H={h} must be a multiple of "
                         f"KVH={kvh} with at most {MAX_GROUP} heads a group")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: q, k, v need unit last-dim "
                         "strides")
    if kind == "tc" and any(
            t.data_ptr() % 16 or any(st * 2 % 16 for st in t.stride()[:3])
            for t in (q, k, v)):
        raise ValueError("flash_attention: the bf16 kernel reads q, k, v "
                         "by TMA, which needs 16-byte aligned bases and "
                         "strides")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    starts = None if kv_start is None else rows_i32(kv_start, b, q.device)
    prefix = None if prefix_len is None else rows_i32(prefix_len, b,
                                                      q.device)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    err = _build.load("flash_attention", _ENTRY[kind])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if starts is None else starts.data_ptr(),
        None if prefix is None else prefix.data_ptr(),
        b, sq, sk, h, kvh, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), int(window), float(softcap), float(scale),
        _build.stream())
    _build.check(f"flash_attention ({kind})", err)
    launches += 1
    tc_launches += kind == "tc"
    return out
