"""Entry points of the RG-LRU, one CUDA kernel with two front ends:

- `rglru(log_a, b, state)`: the scan alone, the signature of
  `repro.kernels.rglru.ops.rglru` without its TPU-only `chunk` / `block_w`
  / `interpret` arguments, plus the initial state;
- `rglru_gated(za, zi, y, b_a, b_i, lru_lambda, state)`: the reference
  model's gate arithmetic (`_rglru_gates`) and the scan in one pass, from
  the gate pre-activations.  The model's recurrent blocks run this one.

Kernel: `repro_torch/csrc/rglru.cu`, which replaces the Pallas
`_rglru_kernel` (src/repro/kernels/rglru/rglru.py:31) and, unlike it,
starts from the given state.  It serves both the prompt's scan (S > 1) and
the decode step (S == 1), with the plan `launch_plan` picks from the
shapes.  A CPU tensor takes the plain version in `ref.py` (the gates by
`rglru_gates_ref`, then `rglru_step_ref` when S == 1, else
`rglru_assoc_ref`, the reference model's form); a CUDA tensor launches
the kernel or raises; a meta tensor takes the CUDA route without a launch
(inside `_build.dry_run`).  `launches` counts kernel launches of both
entries.

Both write the final state into `state` in place and return it, so a
model's stacked `lru_h` is updated without a copy.

`rglru_gated` is differentiable in za, zi, y, b_a, b_i and lru_lambda; the
initial state is a constant of the backward (it must not require grad)
and the final state is not differentiated.  Where autograd records, a
CUDA call goes through `_RGLRUGatedFn`, which keeps a copy of the initial
state and whose backward is the backward kernel (`rglru_gated_backward`:
`rglru_gated_bwd_launch` in the same source, the sequence in chunks as
`bwd_plan` picks them, two kernel launches a call where there is more
than one chunk, else one, each counted in `bwd_launches`; the plain
version `rglru_gated_bwd_ref`).  Serving's tensors require no grad and
launch the forward alone, as before."""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch._device import SM_COUNT, sm_count
from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ref import (rglru_assoc_ref,
                                           rglru_gated_bwd_ref,
                                           rglru_gates_ref, rglru_scan_ref,
                                           rglru_step_ref)

#: Kernel launches made through `rglru` and `rglru_gated` (the CPU path
#: does not count).
launches = 0
#: Kernel launches made through `rglru_gated_backward` (`bwd_plan`'s
#: `launches` a call).
bwd_launches = 0

#: Consecutive channels a thread of the kernel owns.
LANES = 4
#: Threads of a CTA.
CTA_THREADS = 256


class ScanPlan(NamedTuple):
    """How the kernel covers [B, W]: a thread LANES consecutive channels of
    one batch row, `ctas` CTAs of CTA_THREADS threads (a row of the grid a
    batch row).  `vec`: a thread moves its channels as one access a tensor
    (16 bytes of fp32, 8 of bf16); else one channel at a time, and a row's
    last thread only the channels left."""
    vec: bool
    ctas: int


def launch_plan(b: int, s: int, w: int, strides: Sequence[int],
                aligned: bool) -> ScanPlan:
    """The kernel's plan for inputs of shape [b, s, w] with element
    `strides` (batch, step; unit on W), from these alone.  `aligned`: every
    base address (inputs, state, per-channel vectors) is a multiple of
    LANES elements.  Vector accesses need W and the strides of the
    dimensions longer than 1 to be multiples of LANES too."""
    if min(b, s, w) < 1:
        raise ValueError(f"rglru: shape {(b, s, w)} must be positive")
    live = [st for st, n in zip(strides, (b, s)) if n > 1]
    vec = aligned and w % LANES == 0 and all(st % LANES == 0 for st in live)
    return ScanPlan(vec, b * -(-w // (LANES * CTA_THREADS)))


#: Chunk lengths the backward tries, longest first, and the CTAs an SM
#: its walk should have at least (so that B x W channels of a short batch
#: still fill the card).
BWD_CHUNKS = (64, 32, 16, 8)
BWD_FILL = 4
#: Most rows of a CUDA grid (its y dimension): B x chunks must fit.
MAX_GRID_Y = 65535


class BwdPlan(NamedTuple):
    """How the backward covers [B, S, W]: the sequence in `chunks` chunks
    of `chunk` steps (the last may be shorter), a thread a channel of a
    chunk of a batch row; the walk's `ctas` CTAs of CTA_THREADS threads
    (ceil(W / CTA_THREADS) x B x chunks); `launches` kernel launches a
    call: the chunk-local walk over chunks 1 .. chunks - 1 first where
    there is more than one chunk, then the walk from the true carries."""
    chunk: int
    chunks: int
    ctas: int
    launches: int


def bwd_plan(b: int, s: int, w: int, sms: int = SM_COUNT) -> BwdPlan:
    """The backward's plan for [b, s, w] on a card of `sms` SMs, from these
    alone: the longest chunk of BWD_CHUNKS whose walk has BWD_FILL CTAs an
    SM or more (else the shortest), no longer than S, doubled until B x
    chunks fits a grid."""
    if min(b, s, w) < 1:
        raise ValueError(f"rglru backward: shape {(b, s, w)} must be "
                         "positive")
    cols = -(-w // CTA_THREADS)
    for chunk in BWD_CHUNKS:
        if cols * b * -(-s // chunk) >= BWD_FILL * sms:
            break
    chunk = min(chunk, s)
    while b * -(-s // chunk) > MAX_GRID_Y:
        chunk *= 2
    chunks = -(-s // chunk)
    return BwdPlan(chunk, chunks, cols * b * chunks, 1 + (chunks > 1))


def _on_cpu(log_a: torch.Tensor, b: torch.Tensor, state: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    # The plain versions save the state they read for autograd, and the
    # state is overwritten below: where autograd records, they read a copy.
    h0 = state.clone() if _build.records(log_a, b) else state
    if log_a.shape[1] == 1:
        h, last = rglru_step_ref(log_a, b, h0)
    else:
        h, last = rglru_assoc_ref(log_a, b, h0)
    state.copy_(last.detach())
    return h, state


def _check(name: str, inputs: Sequence[torch.Tensor],
           vectors: Sequence[torch.Tensor], state: torch.Tensor,
           dtypes: Sequence[torch.dtype]) -> Tuple[int, int, int, ScanPlan]:
    """Raise on what the kernel cannot take; return (B, S, W, plan)."""
    x = inputs[0]
    tensors = (*inputs, *vectors, state)
    if not _build.on_card(x.device) \
            or any(t.device != x.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if x.dim() != 3 or any(t.shape != x.shape for t in inputs) \
            or x.shape[1] < 1:
        raise ValueError(f"{name}: the inputs must share one [B, S, W] "
                         f"shape with S >= 1, got "
                         f"{[tuple(t.shape) for t in inputs]}")
    bsz, s, w = x.shape
    if x.dtype not in dtypes or any(t.dtype != x.dtype for t in inputs) \
            or any(t.dtype != torch.float32 for t in (*vectors, state)):
        raise TypeError(f"{name}: inputs must share one type of {dtypes}, "
                        f"the state and per-channel vectors float32, got "
                        f"{[t.dtype for t in tensors]}")
    if any(tuple(t.shape) != (w,) or not t.is_contiguous()
           for t in vectors):
        raise ValueError(f"{name}: b_a, b_i and lru_lambda must be "
                         f"contiguous [{w}], got "
                         f"{[tuple(t.shape) for t in vectors]}")
    if tuple(state.shape) != (bsz, w) or not state.is_contiguous():
        raise ValueError(f"{name}: state must be a contiguous [B, W] = "
                         f"{(bsz, w)}, got {tuple(state.shape)}")
    strides = x.stride()
    if strides[2] != 1 or any(t.stride() != strides for t in inputs):
        raise ValueError(f"{name}: the inputs must share their strides, "
                         "with unit stride on W")
    aligned = all(t.data_ptr() % (LANES * t.element_size()) == 0
                  for t in tensors)
    return bsz, s, w, launch_plan(bsz, s, w, strides, aligned)


def rglru(log_a: torch.Tensor, b: torch.Tensor, state: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a, b: fp32 [B, S, W]; state: fp32 [B, W], the initial state.
    Returns (h fp32 [B, S, W] contiguous, state), with `state` overwritten
    by h[:, -1].  Not differentiable on the card (the model runs
    `rglru_gated`, which is).

    On the card: log_a and b share one set of strides with a unit last
    stride (they are read in place); state is contiguous."""
    global launches
    if log_a.device.type == "cpu":
        return _on_cpu(log_a, b, state)
    if _build.records(log_a, b):
        raise NotImplementedError(
            "rglru: the plain front end has no backward kernel (a launch "
            "would cut the autograd graph); differentiate rglru_gated")
    bsz, s, w, plan = _check("rglru", (log_a, b), (), state,
                             (torch.float32,))
    strides = log_a.stride()
    h = torch.empty((bsz, s, w), dtype=torch.float32, device=log_a.device)
    if log_a.is_meta:
        return h, state
    err = _build.load("rglru")(
        log_a.data_ptr(), b.data_ptr(), state.data_ptr(), h.data_ptr(),
        bsz, s, w, strides[0], strides[1], int(plan.vec), _build.stream())
    _build.check("rglru", err)
    launches += 1
    return h, state


def rglru_gated(za: torch.Tensor, zi: torch.Tensor, y: torch.Tensor,
                b_a: torch.Tensor, b_i: torch.Tensor, lru_lambda: torch.Tensor,
                state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence of an RG-LRU block from its gate pre-activations.
    za = y @ w_a, zi = y @ w_i and y: [B, S, W], one type (fp32 or bf16 on
    the card); b_a, b_i, lru_lambda: fp32 [W]; state: fp32 [B, W], the
    initial state.  Returns (h fp32 [B, S, W] contiguous, state), with
    `state` overwritten by h[:, -1] (which carries no gradient):
    h_t = a_t h_{t-1} + b_t with
    log_a = -8 softplus(lambda) sigmoid(za + b_a) and
    b = sqrt(max(1 - a^2, 1e-9)) (sigmoid(zi + b_i) y).

    On the card: za, zi and y share one set of strides with a unit last
    stride (they are read in place); the rest is contiguous."""
    inputs = (za, zi, y, b_a, b_i, lru_lambda)
    recording = _build.records(*inputs)
    if recording and state.requires_grad:
        raise ValueError("rglru_gated: the initial state is a constant of "
                         "the backward and must not require grad")
    if za.device.type == "cpu":
        return _on_cpu(*rglru_gates_ref(*inputs), state)
    plan = _check_gated(*inputs, state)[3]
    if recording:
        return _RGLRUGatedFn.apply(*inputs, state, plan.vec)
    return _gated_forward(*inputs, state, plan.vec), state


def _check_gated(za, zi, y, b_a, b_i, lru_lambda, state):
    return _check("rglru_gated", (za, zi, y), (b_a, b_i, lru_lambda),
                  state, (torch.float32, torch.bfloat16))


def _gated_forward(za, zi, y, b_a, b_i, lru_lambda, state, vec
                   ) -> torch.Tensor:
    """The gated forward kernel on checked CUDA tensors: h, with `state`
    overwritten by h[:, -1]."""
    global launches
    bsz, s, w = za.shape
    strides = za.stride()
    h = torch.empty((bsz, s, w), dtype=torch.float32, device=za.device)
    if za.is_meta:
        return h
    err = _build.load("rglru", "rglru_gated_launch")(
        za.data_ptr(), zi.data_ptr(), y.data_ptr(), b_a.data_ptr(),
        b_i.data_ptr(), lru_lambda.data_ptr(), state.data_ptr(),
        h.data_ptr(), _build.dtype_code(za), bsz, s, w, strides[0],
        strides[1], int(vec), _build.stream())
    _build.check("rglru_gated", err)
    launches += 1
    return h


class _RGLRUGatedFn(torch.autograd.Function):
    """The gated CUDA forward kernel, differentiated by the backward
    kernel from a copy of the initial state taken before the forward
    overwrites it, and from the forward's h (h_{t-1} of every step past
    the first)."""

    @staticmethod
    def forward(ctx, za, zi, y, b_a, b_i, lru_lambda, state, vec):
        h0 = state.clone()
        h = _gated_forward(za, zi, y, b_a, b_i, lru_lambda, state, vec)
        ctx.save_for_backward(za, zi, y, b_a, b_i, lru_lambda, h0, h)
        ctx.mark_dirty(state)
        ctx.mark_non_differentiable(state)
        return h, state

    @staticmethod
    def backward(ctx, dh, _dstate):
        *inputs, h0, h = ctx.saved_tensors
        return (*rglru_gated_backward(dh, *inputs, h0, h), None, None)


def rglru_gated_backward(dh: torch.Tensor, za: torch.Tensor,
                         zi: torch.Tensor, y: torch.Tensor,
                         b_a: torch.Tensor, b_i: torch.Tensor,
                         lru_lambda: torch.Tensor, h0: torch.Tensor,
                         h: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Gradients of `rglru_gated(za, zi, y, b_a, b_i, lru_lambda, h0)`'s h
    given dh (fp32 [B, S, W]), from the initial state h0 (left as it is)
    and the forward's h: (dza, dzi, dy in the inputs' type, d b_a, d b_i,
    d lru_lambda fp32 [W]).  A CPU tensor takes `rglru_gated_bwd_ref`
    (which needs no h); a CUDA tensor launches the backward's kernels as
    `bwd_plan` says (the per-channel sums over B and S in a fixed order:
    the same bits from run to run) or raises."""
    global bwd_launches
    inputs = (za, zi, y, b_a, b_i, lru_lambda)
    if za.device.type == "cpu":
        return rglru_gated_bwd_ref(dh, *inputs, h0)
    dh = dh.contiguous()
    bsz, s, w, _ = _check_gated(*inputs, h0)
    if any(t.dtype != torch.float32 or tuple(t.shape) != (bsz, s, w)
           or not t.is_contiguous() or t.device != za.device
           for t in (h, dh)):
        raise ValueError("rglru_gated backward: h and dh must be contiguous "
                         f"fp32 [{bsz}, {s}, {w}] on {za.device}, got "
                         f"{h.dtype} {tuple(h.shape)} on {h.device} and "
                         f"{dh.dtype} {tuple(dh.shape)} on {dh.device}")
    plan = bwd_plan(bsz, s, w, sm_count(za.device))
    grads = [torch.empty((bsz, s, w), dtype=za.dtype, device=za.device)
             for _ in range(3)]
    sums = [torch.empty((w,), dtype=torch.float32, device=za.device)
            for _ in range(3)]
    # Each (row, chunk)'s three sums (fp64) and the chunk-local walk's
    # carry and product of a: 8.4 MB at recurrentgemma-9b's training shape.
    part = torch.empty((3, bsz * plan.chunks, w), dtype=torch.float64,
                       device=za.device)
    carry = torch.empty((2, bsz * plan.chunks, w), dtype=torch.float32,
                        device=za.device)
    if za.is_meta:
        return (*grads, *sums)
    strides = za.stride()
    err = _build.load("rglru", "rglru_gated_bwd_launch")(
        *(t.data_ptr() for t in (*inputs, h0, h, dh, *grads, part, carry)),
        _build.tickets(za.device, -(-w // CTA_THREADS)).data_ptr(),
        *(t.data_ptr() for t in sums), _build.dtype_code(za), bsz, s, w,
        plan.chunk, strides[0], strides[1], _build.stream())
    _build.check("rglru_gated backward", err)
    bwd_launches += plan.launches
    return (*grads, *sums)


__all__ = ["BwdPlan", "LANES", "ScanPlan", "bwd_plan", "launch_plan",
           "rglru", "rglru_assoc_ref", "rglru_gated", "rglru_gated_backward",
           "rglru_gated_bwd_ref", "rglru_gates_ref", "rglru_scan_ref",
           "rglru_step_ref"]
