"""Entry point of the WKV6 recurrence: `wkv6(r, k, v, logw, bonus, state,
*, chunk)`, the signature of `repro.kernels.rwkv6.ops.wkv6` without its
TPU-only `interpret` switch.

Kernel: `repro_torch/csrc/wkv6.cu`, which replaces the Pallas `_wkv6_kernel`
(src/repro/kernels/rwkv6/rwkv6.py:31) and, unlike it, honours the initial
state.  It serves both the chunked prefill (chunk > 1) and the decode step
(S == 1, chunk 1); the chunked variant's CTAs each own one (b, h) and
stage their inputs as `chunk_plan` says.  A CPU tensor takes
the plain version in `ref.py` (`wkv6_step_ref` when S == 1, else
`wkv6_chunked_ref`); a CUDA tensor launches the kernel or raises.
`launches` counts kernel launches.

Both paths write the final state into `state` in place and return it, so a
model's stacked recurrent state is updated without a copy."""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6.ref import (wkv6_chunked_ref, wkv6_sequential,
                                           wkv6_step_ref)

#: Head dims (N) the kernel is built for.
HEAD_DIMS = (16, 32, 64)
#: Longest chunk the kernel takes (the reference's fp32 exponent budget:
#: |logw| <= 4 over half a chunk stays far inside exp's range).
MAX_CHUNK = 32

#: Bytes of one asynchronous copy (`cp.async`) of the chunked variant.
COPY_BYTES = 16

#: Kernel launches made through `wkv6` (the CPU path does not count).
launches = 0


class ChunkPlan(NamedTuple):
    """How the chunked variant covers [B, S, H, N]: `ctas` CTAs of
    `threads` threads, each owning one (b, h) for the whole sequence;
    `staging` "cp.async" (16-byte asynchronous copies of the next chunk,
    issued while this one computes) or "loads" (plain loads, for inputs
    that are not 16-byte aligned)."""
    staging: str
    ctas: int
    threads: int


def chunk_plan(b: int, h: int, n: int, itemsize: int,
               strides: Tuple[int, ...], aligned: bool) -> ChunkPlan:
    """The chunked variant's plan for r/k/v of `itemsize` bytes with
    element `strides` (batch, seq, head, channel) shared by logw, from
    these alone.  `aligned`: the four base addresses are multiples of 16
    bytes.  A warp takes 16 value columns, and where a head has fewer
    than four such slices (N 16, 32) the warps split the keys too, so that
    a CTA has at least two warps.  Raises ValueError for a head dim the
    kernel is not built for."""
    if n not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim N={n} not in {HEAD_DIMS}")
    ev = COPY_BYTES // itemsize
    copies = aligned and all(st % ev == 0 for st in strides[:3])
    slices = n // 16
    warps = slices * min(4 // slices, n // 8)
    return ChunkPlan("cp.async" if copies else "loads", b * h, 32 * warps)


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
    ptrs = [t.data_ptr() for t in (r, k, v, logw)]
    plan = chunk_plan(b, h, n, r.element_size(), strides,
                      all(p % COPY_BYTES == 0 for p in ptrs))
    y = torch.empty((b, s, h, n), dtype=torch.float32, device=r.device)
    err = _build.load("wkv6")(
        *ptrs, bonus.data_ptr(), state.data_ptr(), y.data_ptr(), code, b, s,
        h, n, chunk, strides[0], strides[1], strides[2],
        int(plan.staging == "cp.async"), _build.stream())
    _build.check("wkv6", err)
    launches += 1
    return y, state
