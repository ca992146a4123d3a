"""Entry point of the grouped expert GEMM: `grouped_gemm(x, w)`, the
signature of `repro.kernels.moe_gemm.ops.grouped_gemm` without its TPU-only
`interpret` switch and block sizes, differentiable in x and w.

Kernel: `repro_torch/csrc/moe_gemm.cu`, which replaces the Pallas
`_moe_gemm_kernel` (src/repro/kernels/moe_gemm/moe_gemm.py:21).  Its bf16
decode variant (C <= 8) is a persistent grid over work units of (expert,
columns) that `decode_plan` lays out from the shapes and the card's SM
count.  A CPU tensor takes the plain version in `ref.py` (differentiable by
autograd); a CUDA tensor launches the kernel or raises.

Where autograd records (grad enabled and x or w requiring grad) the CUDA
call goes through the custom op `repro_torch::grouped_gemm`, so that
selective checkpointing can name it as a matrix product to keep
(`models/transformer.py`, remat "dots"); its backward is `grouped_gemm_dx`
and `grouped_gemm_dw`, kernels of the same file, never a library product.
In bf16 they read dy, w and x in place (the transpose bits of wgmma) on
the backward variant, at every C, on the tiles of `bwd_plan`.  wgmma
transposes 16-bit types only, so in fp32 they run the forward's variants on transposed copies (`transpose_pad`).
`launches` counts forward products, `dx_launches` and `dw_launches` the
backward's products, `transpose_launches` the transposed copies (fp32
only: one for each dx and each dw)."""

from __future__ import annotations

from typing import Iterator, NamedTuple, Tuple

import torch

from repro_torch._device import SM_COUNT, sm_count
from repro_torch.kernels import _build
from repro_torch.kernels.moe_gemm.ref import (moe_gemm_dw_ref,
                                               moe_gemm_dx_ref, moe_gemm_ref)

#: Kernel launches made through `grouped_gemm` (the CPU path does not count).
launches = 0
#: Products launched through `grouped_gemm_dx` and `grouped_gemm_dw`
#: (each also launches one transposed copy, counted below).
dx_launches = 0
dw_launches = 0
#: Transposed copies launched through `transpose_pad` (the fp32 backward).
transpose_launches = 0

#: Rows an expert (capacity C) up to which the decode variants run.
DECODE_ROWS = 8
#: Output columns a unit of the bf16 decode variant takes (one m64 tile of
#: wgmma.m64n8k16, the operands swapped so that w's columns are its rows).
DECODE_COLUMNS = 64


class DecodePlan(NamedTuple):
    """How the bf16 decode variant covers y [E, C, N]: `units` work units
    of (expert, DECODE_COLUMNS columns) over the whole of K, unit u being
    expert u // ceil(N / 64) and column block u % ceil(N / 64); `ctas`
    persistent CTAs, CTA i taking units i, i + ctas, ..."""
    units: int
    ctas: int


def decode_units(plan: DecodePlan, n: int
                 ) -> Iterator[Tuple[int, int, int, int]]:
    """(cta, expert, first column, columns) of every unit, in the order
    the kernel takes them."""
    blocks = -(-n // DECODE_COLUMNS)
    for cta in range(plan.ctas):
        for u in range(cta, plan.units, plan.ctas):
            n0 = (u % blocks) * DECODE_COLUMNS
            yield cta, u // blocks, n0, min(DECODE_COLUMNS, n - n0)


def decode_plan(e: int, c: int, k: int, n: int,
                sms: int = SM_COUNT) -> DecodePlan:
    """The bf16 decode variant's plan for x [E, C, K] @ w [E, K, N] on a
    card of `sms` SMs, from these alone: one CTA an SM at most.  Units of
    64 columns over the whole of K keep the busiest CTA's bytes close to
    the mean: at olmoe-1b-7b's decode products on 132 SMs, 1024 units
    (gate/up) or 2048 (down), at most 8 or 16 a CTA against a mean of 7.76
    or 15.5, 3 % above it.  Raises ValueError for shapes the kernel does
    not take."""
    if not (1 <= e <= 65535 and 1 <= c <= DECODE_ROWS and k > 0 and n > 0
            and k % 8 == 0 and n % 8 == 0 and sms >= 1):
        raise ValueError(
            f"moe_gemm decode: need 1 <= E <= 65535, 1 <= C <= {DECODE_ROWS}"
            f", K and N positive multiples of 8 and sms >= 1; got E={e}, "
            f"C={c}, K={k}, N={n}, sms={sms}")
    units = e * -(-n // DECODE_COLUMNS)
    return DecodePlan(units, min(units, sms))


#: Rows and columns of a CTA's tile of the bf16 backward variant (two
#: warpgroups of 128 x 128 side by side).
BWD_ROWS, BWD_COLS = 128, 256


class BwdPlan(NamedTuple):
    """How the bf16 backward variant covers out [E, M, Nn]: `tiles` tiles
    of BWD_ROWS x BWD_COLS, tile t being expert t // (m_tiles * n_tiles),
    row tile (t // n_tiles) % m_tiles and column tile t % n_tiles; `ctas`
    persistent CTAs, CTA i taking tiles i, i + ctas, ..."""
    tiles: int
    ctas: int
    m_tiles: int
    n_tiles: int


def bwd_plan(e: int, m: int, nn: int, sms: int = SM_COUNT) -> BwdPlan:
    """The bf16 backward variant's plan for out [E, M, Nn] (dx: M = C,
    Nn = K; dw: M = K, Nn = N) on a card of `sms` SMs: one CTA an SM at
    most.  128-row tiles split olmoe-1b-7b's training capacity (C = 640)
    into five whole tiles, and its K and N into whole 256-column tiles.
    Raises ValueError for an empty shape."""
    if not (1 <= e <= 65535 and m > 0 and nn > 0 and sms >= 1):
        raise ValueError(f"moe_gemm backward: need 1 <= E <= 65535, M, Nn "
                         f"and sms positive; got E={e}, M={m}, Nn={nn}, "
                         f"sms={sms}")
    m_tiles, n_tiles = -(-m // BWD_ROWS), -(-nn // BWD_COLS)
    tiles = e * m_tiles * n_tiles
    return BwdPlan(tiles, min(tiles, sms), m_tiles, n_tiles)


def _check_pair(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Both on one CUDA device, of one dtype, 3-D, contiguous and 16-byte
    aligned (the kernels' TMA maps and vector loads)."""
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{name}: operands on {a.device} and {b.device}; "
                         "both must be on one CUDA device")
    if b.dtype != a.dtype:
        raise TypeError(f"{name}: operands are {a.dtype} and {b.dtype}")
    if a.dim() != 3 or b.dim() != 3 or not a.is_contiguous() \
            or not b.is_contiguous() or a.data_ptr() % 16 \
            or b.data_ptr() % 16:
        raise ValueError(f"{name}: operands must be 3-D, contiguous and "
                         "16-byte aligned")


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[e] = x[e] @ w[e] on the card, through the variant that the dtype
    and C pick; checks the operands and raises on what no variant takes."""
    _check_pair("grouped_gemm", x, w)
    if w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"grouped_gemm: need x [E, C, K] and w [E, K, N], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    e, c, k = x.shape
    n = w.shape[2]
    if k % 8 or n % 8:
        raise ValueError(f"grouped_gemm: K={k} and N={n} must be multiples "
                         "of 8 (16-byte vectors)")
    code = _build.dtype_code(x)
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if x.dtype == torch.bfloat16 and c <= DECODE_ROWS:
        plan = decode_plan(e, c, k, n, sm_count(x.device))
        err = _build.load("moe_gemm", "moe_gemm_decode_launch")(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, k, n,
            plan.ctas, _build.stream())
    else:
        err = _build.load("moe_gemm")(x.data_ptr(), w.data_ptr(),
                                      out.data_ptr(), code, e, c, k, n,
                                      _build.stream())
    _build.check("moe_gemm", err)
    return out


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    global launches
    out = _product(x, w)
    launches += 1
    return out


@torch.library.custom_op("repro_torch::grouped_gemm", mutates_args=(),
                         device_types="cuda")
def _grouped_gemm_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _forward(x, w)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, dy):
    x, w = ctx.saved_tensors
    dx = grouped_gemm_dx(dy, w) if ctx.needs_input_grad[0] else None
    dw = grouped_gemm_dw(x, dy) if ctx.needs_input_grad[1] else None
    return dx, dw


_grouped_gemm_op.register_autograd(_backward, setup_context=_setup_context)


def grouped_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[e] = x[e] @ w[e].  x: [E, C, K]; w: [E, K, N], both contiguous and
    of one dtype (fp32 or bf16); K and N multiples of 8 on the card.
    Returns [E, C, N] in x's dtype, accumulated in fp32; differentiable in
    x and w."""
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _grouped_gemm_op(x, w)
    return _forward(x, w)


def transpose_pad(src: torch.Tensor, rows: int) -> torch.Tensor:
    """src [E, R, C] -> [E, C, rows] with out[e, j, i] = src[e, i, j] for
    i < R and zeros for R <= i < rows, by the transposed-copy kernel."""
    global transpose_launches
    e, r, c = src.shape
    if src.device.type != "cuda" or not src.is_contiguous() or rows < r:
        raise ValueError(f"transpose_pad: need a contiguous CUDA [E, R, C] "
                         f"and rows >= R, got {tuple(src.shape)} on "
                         f"{src.device}, rows {rows}")
    out = torch.empty((e, c, rows), dtype=src.dtype, device=src.device)
    err = _build.load("moe_gemm", "moe_transpose_launch")(
        src.data_ptr(), out.data_ptr(), _build.dtype_code(src), e, r, c, rows,
        _build.stream())
    _build.check("moe_gemm transpose", err)
    transpose_launches += 1
    return out


def _bwd_product(which: str, a: torch.Tensor, b: torch.Tensor, e: int,
                 c: int, k: int, n: int) -> torch.Tensor:
    """bf16 dx [E, C, K] (`which` "dx": a = dy, b = w) or dw [E, K, N]
    ("dw": a = x, b = dy), its operands read in place."""
    _check_pair(f"grouped_gemm_{which}", a, b)
    if k % 8 or n % 8:
        raise ValueError(f"grouped_gemm_{which}: K={k} and N={n} must be "
                         "multiples of 8 (16-byte TMA strides)")
    sms = sm_count(a.device)
    if which == "dx":
        out = torch.empty((e, c, k), dtype=a.dtype, device=a.device)
        ctas = bwd_plan(e, c, k, sms).ctas
    else:
        out = torch.empty((e, k, n), dtype=a.dtype, device=a.device)
        ctas = bwd_plan(e, k, n, sms).ctas
    err = _build.load("moe_gemm", f"moe_gemm_{which}_launch")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), e, c, k, n, ctas,
        _build.stream())
    _build.check(f"moe_gemm {which}", err)
    return out


def grouped_gemm_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x's gradient: dx[e] = dy[e] @ w[e]^T for dy [E, C, N] and w
    [E, K, N] -> [E, C, K] in dy's dtype.  On the card in bf16: dy and w
    read in place; in fp32: the grouped GEMM on a transposed copy of w
    ([E, N, K], `transpose_pad`)."""
    global dx_launches
    if dy.device.type == "cpu":
        return moe_gemm_dx_ref(dy, w)
    if dy.dim() != 3 or w.dim() != 3 or w.shape[0] != dy.shape[0] \
            or w.shape[2] != dy.shape[2]:
        raise ValueError(f"grouped_gemm_dx: need dy [E, C, N] and w "
                         f"[E, K, N], got {tuple(dy.shape)} and "
                         f"{tuple(w.shape)}")
    if dy.dtype == torch.bfloat16:
        e, c, n = dy.shape
        out = _bwd_product("dx", dy.contiguous(), w.contiguous(), e, c,
                           w.shape[1], n)
    else:
        out = _product(dy.contiguous(), transpose_pad(w.contiguous(),
                                                      w.shape[1]))
    dx_launches += 1
    return out


def grouped_gemm_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """w's gradient: dw[e] = x[e]^T @ dy[e] for x [E, C, K] and dy
    [E, C, N] -> [E, K, N] in x's dtype.  On the card in bf16: x and dy
    read in place (rows past C read as zeros); in fp32: the grouped GEMM
    on a transposed copy of x ([E, K, C8]) and dy, the contraction over C
    zero-padded to C8, the next multiple of 8 (the kernel's K)."""
    global dw_launches
    if x.device.type == "cpu":
        return moe_gemm_dw_ref(x, dy)
    if x.dim() != 3 or dy.dim() != 3 or dy.shape[:2] != x.shape[:2]:
        raise ValueError(f"grouped_gemm_dw: need x [E, C, K] and dy "
                         f"[E, C, N], got {tuple(x.shape)} and "
                         f"{tuple(dy.shape)}")
    if x.dtype == torch.bfloat16:
        e, c, k = x.shape
        out = _bwd_product("dw", x.contiguous(), dy.contiguous(), e, c, k,
                           dy.shape[2])
    else:
        c = x.shape[1]
        c8 = -(-c // 8) * 8
        dy = dy.contiguous()
        if c8 != c:
            dy = torch.nn.functional.pad(dy, (0, 0, 0, c8 - c))
        out = _product(transpose_pad(x.contiguous(), c8), dy)
    dw_launches += 1
    return out
