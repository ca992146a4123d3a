"""Entry point of the RG-LRU scan: `rglru(log_a, b, state)`, the signature of
`repro.kernels.rglru.ops.rglru` without its TPU-only `chunk` / `block_w` /
`interpret` arguments, plus the initial state.

Kernel: `repro_torch/csrc/rglru.cu`, which replaces the Pallas
`_rglru_kernel` (src/repro/kernels/rglru/rglru.py:31) and, unlike it,
starts from the given state.  It serves both the prompt's scan (S > 1) and
the decode step (S == 1).  A CPU tensor takes the plain version in `ref.py`
(`rglru_step_ref` when S == 1, else `rglru_assoc_ref`, the reference
model's form); a CUDA tensor launches the kernel or raises.  `launches`
counts kernel launches.

Both paths write the final state into `state` in place and return it, so a
model's stacked `lru_h` is updated without a copy."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rglru.ref import (rglru_assoc_ref, rglru_scan_ref,
                                           rglru_step_ref)

#: Kernel launches made through `rglru` (the CPU path does not count).
launches = 0


def rglru(log_a: torch.Tensor, b: torch.Tensor, state: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log_a, b: fp32 [B, S, W]; state: fp32 [B, W], the initial state.
    Returns (h fp32 [B, S, W] contiguous, state), with `state` overwritten
    by h[:, -1].

    On the card: log_a and b share one set of strides with a unit last
    stride (they are read in place); state is contiguous."""
    global launches
    if log_a.device.type == "cpu":
        if log_a.shape[1] == 1:
            h, last = rglru_step_ref(log_a, b, state)
        else:
            h, last = rglru_assoc_ref(log_a, b, state)
        state.copy_(last)
        return h, state
    tensors = (log_a, b, state)
    if log_a.device.type != "cuda" or any(t.device != log_a.device
                                          for t in tensors):
        raise ValueError("rglru: log_a, b and state must all be on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if log_a.dim() != 3 or b.shape != log_a.shape or log_a.shape[1] < 1:
        raise ValueError(f"rglru: log_a and b must share one [B, S, W] shape "
                         f"with S >= 1, got {tuple(log_a.shape)} "
                         f"{tuple(b.shape)}")
    bsz, s, w = log_a.shape
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"rglru: log_a, b and state must be float32, got "
                        f"{[t.dtype for t in tensors]}")
    if tuple(state.shape) != (bsz, w) or not state.is_contiguous():
        raise ValueError(f"rglru: state must be a contiguous [B, W] = "
                         f"{(bsz, w)}, got {tuple(state.shape)}")
    strides = log_a.stride()
    if strides[2] != 1 or b.stride() != strides:
        raise ValueError("rglru: log_a and b must share their strides, with "
                         "unit stride on W")
    h = torch.empty((bsz, s, w), dtype=torch.float32, device=log_a.device)
    err = _build.load("rglru")(
        log_a.data_ptr(), b.data_ptr(), state.data_ptr(), h.data_ptr(),
        bsz, s, w, strides[0], strides[1], _build.stream())
    _build.check("rglru", err)
    launches += 1
    return h, state


__all__ = ["rglru", "rglru_assoc_ref", "rglru_scan_ref", "rglru_step_ref"]
