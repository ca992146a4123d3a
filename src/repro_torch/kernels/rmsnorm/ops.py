"""Entry point of the fused RMSNorm: `rmsnorm(x, scale, eps=)`, the
signature of `repro.kernels.rmsnorm.ops.rmsnorm` without its TPU-only
`interpret` switch.

Kernel: `repro_torch/csrc/rmsnorm.cu`, which replaces the Pallas
`_rmsnorm_kernel` (src/repro/kernels/rmsnorm/rmsnorm.py:19).  A CPU
tensor takes the plain version in `ref.py`; a CUDA tensor launches the
kernel, with the plan `launch_plan` picks from the shapes, or raises.
`launches` counts kernel launches."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

#: Kernel launches made through `rmsnorm` (the CPU path does not count).
launches = 0

#: Bytes of one vector load or store.
VEC_BYTES = 16
#: Threads of a CTA that packs several rows narrower than it.
CTA_THREADS = 128
#: Most threads one row may take (a CTA's limit).
MAX_LANES = 1024
#: Most loads a lane makes, and most values it holds in registers.
MAX_ITEMS, MAX_VALUES = 8, 32


class NormPlan(NamedTuple):
    """How the kernel covers rows of width D: `lanes` threads (a power of
    two) a row, each making `items` loads of `vec` elements (16 bytes'
    worth, or 1 where the rows are not 16-byte aligned), in CTAs of
    `threads` threads holding `rows_per_cta` rows."""
    vec: int
    lanes: int
    items: int
    threads: int
    rows_per_cta: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def launch_plan(d: int, itemsize: int, row_stride: int,
                aligned: bool) -> NormPlan:
    """The kernel's plan for rows of `d` elements of `itemsize` bytes, one
    row every `row_stride` elements, from these alone.  `aligned`: x's and
    scale's base addresses are multiples of 16 bytes.  Rows load 16 bytes
    at a time when they, their stride and d allow it, else one element at
    a time.  A row within a warp takes one load a lane (olmoe's 128-wide
    bf16 qk-norm rows: 16 lanes of 8 values, 8 rows a CTA); a wider row
    two (d_model 2048 bf16: 128 lanes of 16 values), more only past 1024
    lanes.  Raises ValueError for rows wider than a lane's registers
    allow (MAX_VALUES values a lane)."""
    if d < 1:
        raise ValueError(f"rmsnorm: row width {d} must be positive")
    vec = VEC_BYTES // itemsize
    if not (aligned and d % vec == 0 and row_stride % vec == 0):
        vec = 1
    nv = -(-d // vec)
    items = 1 if nv <= 32 else 2
    while _pow2_at_least(-(-nv // items)) > MAX_LANES:
        items *= 2
    if items > MAX_ITEMS or items * vec > MAX_VALUES:
        raise ValueError(f"rmsnorm: rows of {d} elements are wider than "
                         f"{MAX_LANES} lanes hold in registers (loads of "
                         f"{vec} elements)")
    lanes = _pow2_at_least(-(-nv // items))
    threads = max(lanes, CTA_THREADS)
    return NormPlan(vec, lanes, items, threads, threads // lanes)


def rows_view(x: torch.Tensor) -> torch.Tensor:
    """x as [rows, D] without a copy; raises when its strides forbid it."""
    if x.dim() == 0 or x.stride(-1) != 1:
        raise ValueError(f"rmsnorm needs a unit last-dim stride, got "
                         f"shape {tuple(x.shape)} strides {x.stride()}")
    try:
        return x.view(-1, x.shape[-1])
    except RuntimeError as e:
        raise ValueError(f"rmsnorm cannot view shape {tuple(x.shape)} with "
                         f"strides {x.stride()} as rows") from e


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; scale: [D].  Returns x * rsqrt(mean(x^2) + eps) *
    (1 + scale), computed in fp32 and cast back to x's dtype."""
    global launches
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on "
                         f"{scale.device}; both must be on one CUDA device")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.dtype != x.dtype \
            or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale must be contiguous [{d}] "
                         f"{x.dtype}, got {tuple(scale.shape)} {scale.dtype}")
    x2 = rows_view(x)
    code = _build.dtype_code(x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    plan = launch_plan(d, x.element_size(), x2.stride(0),
                       x2.data_ptr() % VEC_BYTES == 0
                       and scale.data_ptr() % VEC_BYTES == 0)
    err = _build.load("rmsnorm")(
        x2.data_ptr(), scale.data_ptr(), out.data_ptr(), code,
        x2.shape[0], d, x2.stride(0), plan.vec, plan.lanes, plan.items,
        float(eps), _build.stream())
    _build.check("rmsnorm", err)
    launches += 1
    return out
