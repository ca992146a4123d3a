"""Entry point of the fused RMSNorm: `rmsnorm(x, scale, eps=)`, the
signature of `repro.kernels.rmsnorm.ops.rmsnorm` without its TPU-only
`interpret` switch, differentiable in x and scale.

Kernel: `repro_torch/csrc/rmsnorm.cu`, which replaces the Pallas
`_rmsnorm_kernel` (src/repro/kernels/rmsnorm/rmsnorm.py:19).  A CPU
tensor takes the plain version in `ref.py` (differentiable by autograd);
a CUDA tensor launches the kernel, with the plan `launch_plan` picks from
the shapes, or raises.  Where autograd records (grad enabled and x or
scale requiring grad) the CUDA call goes through `_RMSNormFn`, whose
backward is the kernel's two backward entries (`rmsnorm_backward`: the
rows with plan `bwd_plan`, then the column sum of dscale's partials);
serving's tensors require no grad and launch the forward alone, as before.
`launches` counts forward launches, `bwd_launches` the backward's rows
kernel and `dscale_launches` its column sum."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import (dscale_sum_ref, rmsnorm_bwd_ref,
                                             rmsnorm_ref)

#: Kernel launches made through `rmsnorm` (the CPU path does not count).
launches = 0
#: Launches made through `rmsnorm_backward`: its rows kernel, and the
#: column sum of dscale's partials (`dscale_sum`).
bwd_launches = 0
dscale_launches = 0

#: Bytes of one vector load or store.
VEC_BYTES = 16
#: Threads of a CTA that packs several rows narrower than it.
CTA_THREADS = 128
#: Most threads one row may take (a CTA's limit).
MAX_LANES = 1024
#: Most loads a lane makes, and most values it holds in registers.
MAX_ITEMS, MAX_VALUES = 8, 32
#: The backward: least threads a CTA, most CTAs a launch (four an SM of
#: the H100's 132; rows past them loop), most shared memory a CTA.
BWD_THREADS, BWD_MAX_CTAS, BWD_SMEM_BYTES = 256, 528, 48 * 1024


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


class BwdPlan(NamedTuple):
    """How the backward covers `rows` rows of width D: `lanes` threads (a
    power of two, 32-1024) a row, CTAs of `threads` threads (threads /
    lanes rows at a time), `ctas` CTAs walking the rows grid-strided."""
    lanes: int
    threads: int
    ctas: int


def bwd_plan(rows: int, d: int) -> BwdPlan:
    """The backward's plan for `rows` rows of `d` elements, from these
    alone: a lane takes about 8 columns of a row (olmoe's 128-wide qk-norm
    rows: one warp a row, 8 rows a CTA; d_model 2048: 256 lanes, one row a
    CTA), and at most BWD_MAX_CTAS CTAs.  Each CTA keeps an fp32 column
    partial for each of its rows in flight, so threads / lanes x d x 4
    bytes of shared memory; raises ValueError past BWD_SMEM_BYTES."""
    if rows < 1 or d < 1:
        raise ValueError(f"rmsnorm backward: need rows and width >= 1, got "
                         f"{rows} x {d}")
    lanes = min(max(_pow2_at_least(-(-d // 8)), 32), MAX_LANES)
    threads = max(lanes, BWD_THREADS)
    if threads // lanes * d * 4 > BWD_SMEM_BYTES:
        raise ValueError(f"rmsnorm backward: rows of {d} elements need more "
                         f"than {BWD_SMEM_BYTES} bytes of column partials")
    per_cta = threads // lanes
    return BwdPlan(lanes, threads, min(-(-rows // per_cta), BWD_MAX_CTAS))


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


def _check(x: torch.Tensor, scale: torch.Tensor) -> None:
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on "
                         f"{scale.device}; both must be on one CUDA device")
    d = x.shape[-1]
    if scale.shape != (d,) or scale.dtype != x.dtype \
            or not scale.is_contiguous():
        raise ValueError(f"rmsnorm: scale must be contiguous [{d}] "
                         f"{x.dtype}, got {tuple(scale.shape)} {scale.dtype}")


def _forward(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """The forward kernel on checked CUDA tensors."""
    global launches
    d = x.shape[-1]
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


class _RMSNormFn(torch.autograd.Function):
    """The CUDA forward kernel, differentiated by the backward kernel."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_backward(dy, x, scale, eps=ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; scale: [D].  Returns x * rsqrt(mean(x^2) + eps) *
    (1 + scale), computed in fp32 and cast back to x's dtype;
    differentiable in x and scale."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    _check(x, scale)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNormFn.apply(x, scale, eps)
    return _forward(x, scale, eps)


def rmsnorm_backward(dy: torch.Tensor, x: torch.Tensor,
                     scale: torch.Tensor, *, eps: float = 1e-6):
    """Gradients of `rmsnorm(x, scale, eps=eps)` given dy (x's shape, any
    strides): (dx in x's dtype and shape, dscale [D] in scale's dtype),
    computed in fp32.  A CPU tensor takes `rmsnorm_bwd_ref`; a CUDA tensor
    launches the backward kernel (dscale summed in a fixed order, the same
    bits from run to run) or raises."""
    global bwd_launches
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(dy, x, scale, eps)
    _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"rmsnorm backward: dy {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device} for x {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    d = x.shape[-1]
    x2 = rows_view(x)
    # The gradient may come from a view (a slice along the sequence): the
    # kernel takes a row stride, so only a layout without one is copied.
    try:
        dy2 = rows_view(dy)
    except ValueError:
        dy2 = dy.contiguous().view(-1, d)
    rows = x2.shape[0]
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return dx, torch.zeros((d,), dtype=scale.dtype, device=x.device)
    plan = bwd_plan(rows, d)
    part = torch.empty((plan.ctas, d), dtype=torch.float32, device=x.device)
    err = _build.load("rmsnorm", "rmsnorm_bwd_launch")(
        x2.data_ptr(), dy2.data_ptr(), scale.data_ptr(), dx.data_ptr(),
        part.data_ptr(), _build.dtype_code(x), rows, d, x2.stride(0),
        dy2.stride(0), plan.lanes, plan.threads, plan.ctas, float(eps),
        _build.stream())
    _build.check("rmsnorm backward", err)
    bwd_launches += 1
    return dx, dscale_sum(part, scale.dtype)


def dscale_sum(part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The column sum of `part` [ctas, D] (fp32, contiguous), its rows
    added in order, as a [D] tensor of `dtype`: the backward's dscale from
    its CTAs' partials.  A CPU tensor takes `dscale_sum_ref`; a CUDA tensor
    launches the column-sum kernel or raises."""
    global dscale_launches
    if part.device.type == "cpu":
        return dscale_sum_ref(part, dtype)
    if part.device.type != "cuda" or part.dtype != torch.float32 \
            or part.dim() != 2 or not part.is_contiguous():
        raise ValueError(f"rmsnorm dscale: need contiguous fp32 [ctas, D] on "
                         f"the card, got {tuple(part.shape)} {part.dtype} on "
                         f"{part.device}")
    out = torch.empty((part.shape[1],), dtype=dtype, device=part.device)
    err = _build.load("rmsnorm", "rmsnorm_dscale_launch")(
        part.data_ptr(), out.data_ptr(), _build.dtype_code(out),
        part.shape[0], part.shape[1], _build.stream())
    _build.check("rmsnorm dscale", err)
    dscale_launches += 1
    return out
