"""Entry point of the fused RMSNorm: `rmsnorm(x, scale, eps=)`, the
signature of `repro.kernels.rmsnorm.ops.rmsnorm` without its TPU-only
`interpret` switch, differentiable in x and scale.

Kernel: `repro_torch/csrc/rmsnorm.cu`, which replaces the Pallas
`_rmsnorm_kernel` (src/repro/kernels/rmsnorm/rmsnorm.py:19).  A CPU
tensor takes the plain version in `ref.py` (differentiable by autograd);
a CUDA tensor launches the kernel, with the plan `launch_plan` picks from
the shapes, or raises.  Where autograd records (grad enabled and x or
scale requiring grad) the CUDA call goes through `_RMSNormFn`, whose
backward is the backward kernel (`rmsnorm_backward`, plan `bwd_plan`: one
pass over the rows in registers and dscale's column sum, in one launch);
serving's tensors require no grad and launch the forward alone, as before.
`launches` counts forward launches, `bwd_launches` backward launches."""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from repro_torch._device import SM_COUNT, sm_count
from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

#: Kernel launches made through `rmsnorm` (the CPU path does not count).
launches = 0
#: Kernel launches made through `rmsnorm_backward` (one a call).
bwd_launches = 0

#: Bytes of one vector load or store.
VEC_BYTES = 16
#: Threads of a CTA that packs several rows narrower than it.
CTA_THREADS = 128
#: Most threads one row may take (a CTA's limit).
MAX_LANES = 1024
#: Most loads a lane makes, and most values it holds in registers.
MAX_ITEMS, MAX_VALUES = 8, 32
#: The backward: threads a CTA (one CTA an SM, 64 registers a thread), most
#: rows a CTA holds at once where a row spans warps (named barriers 1-15),
#: and most bytes of a row a lane loads from each of x, dy and scale (all
#: three stay in registers, beside its fp32 dscale partials: 16 values a
#: lane in bf16, 8 in fp32).
BWD_THREADS, BWD_MAX_SLOTS, BWD_MAX_BYTES = 1024, 15, 32


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
    """How the backward covers `rows` rows of width D in one launch: the
    forward's row layout (`vec`, `lanes`, `items`: see NormPlan), CTAs of
    `threads` threads holding `slots` rows at a time, `ctas` CTAs walking
    the rows slot-strided, and dscale's partials summed in groups of
    `group` CTAs, then across the groups."""
    vec: int
    lanes: int
    items: int
    threads: int
    slots: int
    ctas: int
    group: int

    @property
    def groups(self) -> int:
        return -(-self.ctas // self.group)


def bwd_plan(rows: int, d: int, itemsize: int, x_stride: int,
             dy_stride: int, aligned: bool, sms: int = SM_COUNT) -> BwdPlan:
    """The backward's plan for `rows` rows of `d` elements of `itemsize`
    bytes, x's rows `x_stride` elements apart and dy's `dy_stride`, on a
    card of `sms` SMs, from these alone.  `aligned`: the bases of x, dy,
    scale and dx are multiples of 16 bytes.  A row is laid out as the
    forward lays it (`launch_plan`; 16-byte loads only where both strides
    allow them), in CTAs of BWD_THREADS threads (BWD_MAX_SLOTS rows at most
    where a row spans warps), one CTA an SM, no more CTAs than the rows
    fill; the column sum in groups of ceil(sqrt(ctas)) CTAs.  At llama's
    4096 x 2048 bf16 rows: 128 lanes of 16 values, 8 rows a CTA, 132 CTAs;
    at olmoe's 65536 x 128 qk-norm rows: 16 lanes of 8, 64 rows a CTA, 132
    CTAs.  Raises ValueError for rows wider than BWD_MAX_BYTES a lane."""
    if rows < 1:
        raise ValueError(f"rmsnorm backward: need rows >= 1, got {rows}")
    vec = VEC_BYTES // itemsize
    p = launch_plan(d, itemsize, x_stride, aligned and dy_stride % vec == 0)
    if p.items * p.vec * itemsize > BWD_MAX_BYTES:
        raise ValueError(f"rmsnorm backward: rows of {d} elements need "
                         f"{p.items * p.vec * itemsize} bytes a lane, more "
                         f"than the {BWD_MAX_BYTES} its registers hold")
    threads = max(p.lanes, BWD_THREADS)
    if p.lanes > 32:
        threads = min(threads, BWD_MAX_SLOTS * p.lanes)
    slots = threads // p.lanes
    ctas = min(-(-rows // slots), sms)
    return BwdPlan(p.vec, p.lanes, p.items, threads, slots, ctas,
                   math.isqrt(ctas - 1) + 1)


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
    launches the backward kernel once (dscale summed in a fixed order, the
    same bits from run to run) or raises."""
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
    dscale = torch.empty((d,), dtype=scale.dtype, device=x.device)
    if rows == 0:
        return dx, dscale.zero_()
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in (x2, dy2, scale, dx))
    plan = bwd_plan(rows, d, x.element_size(), x2.stride(0), dy2.stride(0),
                    aligned, sm_count(x.device))
    part = torch.empty(((plan.ctas + plan.groups) * d,), dtype=torch.float32,
                       device=x.device)
    err = _build.load("rmsnorm", "rmsnorm_bwd_launch")(
        x2.data_ptr(), dy2.data_ptr(), scale.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), part.data_ptr(),
        _build.tickets(x.device, plan.groups + 1).data_ptr(),
        _build.dtype_code(x), rows, d, x2.stride(0), dy2.stride(0), plan.vec,
        plan.lanes,
        plan.items, plan.threads, plan.ctas, plan.group, float(eps),
        _build.stream())
    _build.check("rmsnorm backward", err)
    bwd_launches += 1
    return dx, dscale
