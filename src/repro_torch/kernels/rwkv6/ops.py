"""Entry point of the WKV6 recurrence: `wkv6(r, k, v, logw, bonus, state,
*, chunk)`, the signature of `repro.kernels.rwkv6.ops.wkv6` without its
TPU-only `interpret` switch.

Kernel: `repro_torch/csrc/wkv6.cu`, which replaces the Pallas `_wkv6_kernel`
(src/repro/kernels/rwkv6/rwkv6.py:31) and, unlike it, honours the initial
state.  It serves both the chunked prefill (chunk > 1) and the decode step
(S == 1, chunk 1).  A CPU tensor takes the plain version in `ref.py`
(`wkv6_step_ref` when S == 1, else `wkv6_chunked_ref`); a CUDA tensor
launches the kernel or raises.  `launches` counts kernel launches.

Both paths write the final state into `state` in place and return it, so a
model's stacked recurrent state is updated without a copy."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6.ref import (wkv6_chunked_ref, wkv6_sequential,
                                           wkv6_step_ref)

#: Head dims (N) the kernel is built for.
HEAD_DIMS = (16, 32, 64)
#: Longest chunk the kernel takes (the reference's fp32 exponent budget:
#: |logw| <= 4 over half a chunk stays far inside exp's range).
MAX_CHUNK = 32

#: Kernel launches made through `wkv6` (the CPU path does not count).
launches = 0


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, bonus: torch.Tensor, state: torch.Tensor, *,
         chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v: [B, S, H, N] (fp32 or bf16, one dtype); logw fp32
    [B, S, H, N]; bonus fp32 [H, N]; state fp32 [B, H, N, N], indexed
    [key, value].  Returns (y fp32 [B, S, H, N], state), with `state`
    overwritten by the final state.

    On the card: N in HEAD_DIMS, 1 <= chunk <= MAX_CHUNK dividing S; r, k,
    v and logw share one set of strides with a unit last stride (they are
    read in place); bonus and state are contiguous."""
    global launches
    if r.device.type == "cpu":
        if r.shape[1] == 1:
            y, new = wkv6_step_ref(r, k, v, logw, bonus, state)
        else:
            y, new = wkv6_chunked_ref(r, k, v, logw, bonus, state, chunk)
        state.copy_(new)
        return y, state
    tensors = (r, k, v, logw, bonus, state)
    if r.device.type != "cuda" or any(t.device != r.device
                                      for t in tensors):
        raise ValueError("wkv6: r, k, v, logw, bonus and state must all be "
                         "on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"wkv6: r, k, v and logw must share one [B, S, H, "
                         f"N] shape, got {[tuple(t.shape) for t in tensors]}")
    b, s, h, n = r.shape
    if n not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim N={n} not in {HEAD_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK or s % chunk:
        raise ValueError(f"wkv6: chunk {chunk} must be in [1, {MAX_CHUNK}] "
                         f"and divide S={s}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6: r, k, v dtypes {r.dtype}, {k.dtype}, "
                        f"{v.dtype} differ")
    code = _build.dtype_code(r)
    if logw.dtype != torch.float32 or bonus.dtype != torch.float32 \
            or state.dtype != torch.float32:
        raise TypeError("wkv6: logw, bonus and state must be float32")
    if tuple(bonus.shape) != (h, n) or tuple(state.shape) != (b, h, n, n):
        raise ValueError(f"wkv6: bonus {tuple(bonus.shape)} / state "
                         f"{tuple(state.shape)} do not fit [B, S, H, N] = "
                         f"{tuple(r.shape)}")
    strides = r.stride()
    if strides[3] != 1 or any(t.stride() != strides for t in (k, v, logw)):
        raise ValueError("wkv6: r, k, v and logw must share their strides, "
                         "with unit stride on N")
    if not bonus.is_contiguous() or not state.is_contiguous():
        raise ValueError("wkv6: bonus and state must be contiguous")
    y = torch.empty((b, s, h, n), dtype=torch.float32, device=r.device)
    err = _build.load("wkv6")(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        bonus.data_ptr(), state.data_ptr(), y.data_ptr(), code, b, s, h, n,
        chunk, strides[0], strides[1], strides[2], _build.stream())
    _build.check("wkv6", err)
    launches += 1
    return y, state
