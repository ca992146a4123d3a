"""Entry point of the WKV6 recurrence: `wkv6(r, k, v, logw, bonus, state,
*, chunk)`, the signature of `repro.kernels.rwkv6.ops.wkv6` without its
TPU-only `interpret` switch.

Kernel: `repro_torch/csrc/wkv6.cu`, which replaces the Pallas `_wkv6_kernel`
(src/repro/kernels/rwkv6/rwkv6.py:31) and, unlike it, honours the initial
state.  It serves both the chunked prefill (chunk > 1) and the decode step
(S == 1, chunk 1); the chunked variant's CTAs each own one (b, h) and
stage their inputs as `chunk_plan` says.  A CPU tensor takes
the plain version in `ref.py` (`wkv6_step_ref` when S == 1, else
`wkv6_chunked_ref`); a CUDA tensor launches the kernel or raises; a meta
tensor takes the CUDA route without a launch (inside `_build.dry_run`).
`launches` counts kernel launches.

Both paths write the final state into `state` in place and return it, so a
model's stacked recurrent state is updated without a copy.

`wkv6` is differentiable in r, k, v, logw and bonus; the initial state is
a constant of the backward (it must not require grad) and the final state
is not differentiated.  Where autograd records, a CUDA call goes through
`_WKV6Fn`, which keeps a copy of the initial state and whose backward is
the backward kernel (`wkv6_backward`: `wkv6_bwd_launch` in the same
source, the chunked form on tensor cores in chunks of BWD_CHUNK with the
plan `bwd_plan` picks, one launch a call, counted in `bwd_launches`; the
plain version `wkv6_bwd_ref`, autograd of `wkv6_chunked_ref`).  Serving's
tensors require no grad and launch the forward alone, as before."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6.ref import (wkv6_bwd_ref, wkv6_chunked_ref,
                                           wkv6_sequential, wkv6_step_ref)

#: Head dims (N) the kernel is built for.
HEAD_DIMS = (16, 32, 64)
#: Longest chunk the kernel takes (the reference's fp32 exponent budget:
#: |logw| <= 4 over half a chunk stays far inside exp's range).
MAX_CHUNK = 32

#: Bytes of one asynchronous copy (`cp.async`) of the chunked variant.
COPY_BYTES = 16

#: Kernel launches made through `wkv6` (the CPU path does not count).
launches = 0
#: Kernel launches made through `wkv6_backward` (one a call).
bwd_launches = 0


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


#: Positions a chunk of the backward kernel (the last padded with zeros):
#: the kernel takes no chunk, whatever the forward's was.
BWD_CHUNK = 16


class BwdPlan(NamedTuple):
    """How the backward kernel covers [B, S, H, N]: `ctas` CTAs of
    `threads` threads, one a (b, h), a warp 16 keys; each walks `chunks`
    chunks of BWD_CHUNK positions forward and then backward; `staging` as
    ChunkPlan's (r, k, v, logw and dy)."""
    staging: str
    ctas: int
    threads: int
    chunks: int


def bwd_plan(b: int, s: int, h: int, n: int, itemsize: int,
             strides: Tuple[int, ...], aligned: bool) -> BwdPlan:
    """The backward kernel's plan for r/k/v of `itemsize` bytes with
    element `strides` (batch, seq, head, channel) shared by logw, from
    these alone.  `aligned`: the base addresses of r, k, v, logw and dy
    are multiples of 16 bytes.  Raises ValueError for a head dim the
    kernel is not built for or an empty shape."""
    if n not in HEAD_DIMS:
        raise ValueError(f"wkv6 backward: head dim N={n} not in {HEAD_DIMS}")
    if min(b, s, h) < 1:
        raise ValueError(f"wkv6 backward: shape {(b, s, h, n)} must be "
                         "positive")
    ev = COPY_BYTES // itemsize
    copies = aligned and all(st % ev == 0 for st in strides[:3])
    return BwdPlan("cp.async" if copies else "loads", b * h, 2 * n,
                   -(-s // BWD_CHUNK))


def bwd_ctas_an_sm(dtype: torch.dtype, n: int, staging: str) -> int:
    """CTAs of the built backward kernel for r/k/v of `dtype`, head dim
    `n` and `staging` that one SM of the current CUDA device holds at
    once (`cudaOccupancyMaxActiveBlocksPerMultiprocessor`: its registers,
    shared memory and launch bound)."""
    if n not in HEAD_DIMS:
        raise ValueError(f"wkv6 backward: head dim N={n} not in {HEAD_DIMS}")
    ctas = ctypes.c_int(0)
    err = _build.load("wkv6", "wkv6_bwd_occupancy")(
        _build.dtype_code(torch.empty(0, dtype=dtype)), n,
        int(staging == "cp.async"), ctypes.addressof(ctas))
    _build.check("wkv6 backward occupancy", err)
    return ctas.value


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, bonus: torch.Tensor, state: torch.Tensor, *,
         chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v: [B, S, H, N] (fp32 or bf16, one dtype); logw fp32
    [B, S, H, N]; bonus fp32 [H, N]; state fp32 [B, H, N, N], indexed
    [key, value].  Returns (y fp32 [B, S, H, N], state), with `state`
    overwritten by the final state (which carries no gradient).

    On the card: N in HEAD_DIMS, 1 <= chunk <= MAX_CHUNK dividing S; r, k,
    v and logw share one set of strides with a unit last stride (they are
    read in place); bonus and state are contiguous."""
    recording = _build.records(r, k, v, logw, bonus)
    if recording and state.requires_grad:
        raise ValueError("wkv6: the initial state is a constant of the "
                         "backward and must not require grad")
    if r.device.type == "cpu":
        # The plain version saves the state it reads for autograd, and
        # the state is overwritten below: where autograd records, it
        # reads a copy.
        src = state.clone() if recording else state
        if r.shape[1] == 1:
            y, new = wkv6_step_ref(r, k, v, logw, bonus, src)
        else:
            y, new = wkv6_chunked_ref(r, k, v, logw, bonus, src, chunk)
        state.copy_(new.detach())
        return y, state
    _check(r, k, v, logw, bonus, state)
    if not 1 <= chunk <= MAX_CHUNK or r.shape[1] % chunk:
        raise ValueError(f"wkv6: chunk {chunk} must be in [1, {MAX_CHUNK}] "
                         f"and divide S={r.shape[1]}")
    if recording:
        return _WKV6Fn.apply(r, k, v, logw, bonus, state, chunk)
    return _forward(r, k, v, logw, bonus, state, chunk), state


def _check(r, k, v, logw, bonus, state) -> None:
    """Raise on what the kernels cannot take."""
    tensors = (r, k, v, logw, bonus, state)
    if not _build.on_card(r.device) \
            or any(t.device != r.device for t in tensors):
        raise ValueError("wkv6: r, k, v, logw, bonus and state must all be "
                         "on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"wkv6: r, k, v and logw must share one [B, S, H, "
                         f"N] shape, got {[tuple(t.shape) for t in tensors]}")
    b, s, h, n = r.shape
    if n not in HEAD_DIMS:
        raise ValueError(f"wkv6: head dim N={n} not in {HEAD_DIMS}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6: r, k, v dtypes {r.dtype}, {k.dtype}, "
                        f"{v.dtype} differ")
    _build.dtype_code(r)
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


def _forward(r, k, v, logw, bonus, state, chunk) -> torch.Tensor:
    """The forward kernel on checked CUDA tensors: y, with `state`
    overwritten by the final state."""
    global launches
    b, s, h, n = r.shape
    strides = r.stride()
    ptrs = [t.data_ptr() for t in (r, k, v, logw)]
    plan = chunk_plan(b, h, n, r.element_size(), strides,
                      all(p % COPY_BYTES == 0 for p in ptrs))
    y = torch.empty((b, s, h, n), dtype=torch.float32, device=r.device)
    if r.is_meta:
        return y
    err = _build.load("wkv6")(
        *ptrs, bonus.data_ptr(), state.data_ptr(), y.data_ptr(),
        _build.dtype_code(r), b, s, h, n, chunk, strides[0], strides[1],
        strides[2], int(plan.staging == "cp.async"), _build.stream())
    _build.check("wkv6", err)
    launches += 1
    return y


class _WKV6Fn(torch.autograd.Function):
    """The CUDA forward kernel, differentiated by the backward kernel from
    a copy of the initial state taken before the forward overwrites it."""

    @staticmethod
    def forward(ctx, r, k, v, logw, bonus, state, chunk):
        state0 = state.clone()
        y = _forward(r, k, v, logw, bonus, state, chunk)
        ctx.save_for_backward(r, k, v, logw, bonus, state0)
        ctx.mark_dirty(state)
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    def backward(ctx, dy, _dstate):
        r, k, v, logw, bonus, state0 = ctx.saved_tensors
        return (*wkv6_backward(dy, r, k, v, logw, bonus, state0), None,
                None)


def wkv6_backward(dy: torch.Tensor, r: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, logw: torch.Tensor, bonus: torch.Tensor,
                  state: torch.Tensor, *, chunk: int = 32
                  ) -> Tuple[torch.Tensor, ...]:
    """Gradients of `wkv6(r, k, v, logw, bonus, state)`'s y given dy (fp32,
    y's shape), from the initial state `state` (left as it is): (dr, dk, dv
    in r's dtype, dlogw fp32 [B, S, H, N], dbonus fp32 [H, N]).  A CPU
    tensor takes `wkv6_bwd_ref` (chunked at `chunk`; the kernel takes no
    chunk: its own are BWD_CHUNK positions); a CUDA tensor launches the
    backward kernel once, as `bwd_plan` says (dbonus summed over the batch
    in a fixed order: the same bits from run to run), or raises."""
    global bwd_launches
    if r.device.type == "cpu":
        return wkv6_bwd_ref(dy, r, k, v, logw, bonus, state,
                            min(chunk, r.shape[1]))
    _check(r, k, v, logw, bonus, state)
    b, s, h, n = r.shape
    if dy.shape != r.shape or dy.dtype != torch.float32 \
            or dy.device != r.device:
        raise ValueError(f"wkv6 backward: dy {tuple(dy.shape)} {dy.dtype} "
                         f"on {dy.device} for y {tuple(r.shape)} float32 on "
                         f"{r.device}")
    dy = dy.contiguous()
    dr, dk, dv = (torch.empty((b, s, h, n), dtype=r.dtype, device=r.device)
                  for _ in range(3))
    dlogw = torch.empty((b, s, h, n), dtype=torch.float32, device=r.device)
    dbonus = torch.empty((h, n), dtype=torch.float32, device=r.device)
    part = torch.empty((b, h, n), dtype=torch.float32, device=r.device)
    if r.is_meta:
        return dr, dk, dv, dlogw, dbonus
    strides = r.stride()
    plan = bwd_plan(b, s, h, n, r.element_size(), strides,
                    all(t.data_ptr() % COPY_BYTES == 0
                        for t in (r, k, v, logw, dy)))
    err = _build.load("wkv6", "wkv6_bwd_launch")(
        *(t.data_ptr() for t in (r, k, v, logw, bonus, state, dy, dr, dk, dv,
                                 dlogw, dbonus, part)),
        _build.tickets(r.device, h).data_ptr(), _build.dtype_code(r), b, s,
        h, n, strides[0], strides[1], strides[2],
        int(plan.staging == "cp.async"), _build.stream())
    _build.check("wkv6 backward", err)
    bwd_launches += 1
    return dr, dk, dv, dlogw, dbonus
