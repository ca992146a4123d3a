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
the kernel or raises.  `launches` counts kernel launches of both entries.

Both write the final state into `state` in place and return it, so a
model's stacked `lru_h` is updated without a copy."""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ref import (rglru_assoc_ref, rglru_gates_ref,
                                           rglru_scan_ref, rglru_step_ref)

#: Kernel launches made through `rglru` and `rglru_gated` (the CPU path
#: does not count).
launches = 0

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


def _on_cpu(log_a: torch.Tensor, b: torch.Tensor, state: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if log_a.shape[1] == 1:
        h, last = rglru_step_ref(log_a, b, state)
    else:
        h, last = rglru_assoc_ref(log_a, b, state)
    state.copy_(last)
    return h, state


def _check(name: str, inputs: Sequence[torch.Tensor],
           vectors: Sequence[torch.Tensor], state: torch.Tensor,
           dtypes: Sequence[torch.dtype]) -> Tuple[int, int, int, ScanPlan]:
    """Raise on what the kernel cannot take; return (B, S, W, plan)."""
    x = inputs[0]
    tensors = (*inputs, *vectors, state)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
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
    by h[:, -1].

    On the card: log_a and b share one set of strides with a unit last
    stride (they are read in place); state is contiguous."""
    global launches
    if log_a.device.type == "cpu":
        return _on_cpu(log_a, b, state)
    bsz, s, w, plan = _check("rglru", (log_a, b), (), state,
                             (torch.float32,))
    strides = log_a.stride()
    h = torch.empty((bsz, s, w), dtype=torch.float32, device=log_a.device)
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
    `state` overwritten by h[:, -1]: h_t = a_t h_{t-1} + b_t with
    log_a = -8 softplus(lambda) sigmoid(za + b_a) and
    b = sqrt(max(1 - a^2, 1e-9)) (sigmoid(zi + b_i) y).

    On the card: za, zi and y share one set of strides with a unit last
    stride (they are read in place); the rest is contiguous."""
    global launches
    if za.device.type == "cpu":
        log_a, b = rglru_gates_ref(za, zi, y, b_a, b_i, lru_lambda)
        return _on_cpu(log_a, b, state)
    bsz, s, w, plan = _check("rglru_gated", (za, zi, y),
                             (b_a, b_i, lru_lambda), state,
                             (torch.float32, torch.bfloat16))
    strides = za.stride()
    h = torch.empty((bsz, s, w), dtype=torch.float32, device=za.device)
    err = _build.load("rglru", "rglru_gated_launch")(
        za.data_ptr(), zi.data_ptr(), y.data_ptr(), b_a.data_ptr(),
        b_i.data_ptr(), lru_lambda.data_ptr(), state.data_ptr(),
        h.data_ptr(), _build.dtype_code(za), bsz, s, w, strides[0],
        strides[1], int(plan.vec), _build.stream())
    _build.check("rglru_gated", err)
    launches += 1
    return h, state


__all__ = ["LANES", "ScanPlan", "launch_plan", "rglru", "rglru_assoc_ref",
           "rglru_gated", "rglru_gates_ref", "rglru_scan_ref",
           "rglru_step_ref"]
