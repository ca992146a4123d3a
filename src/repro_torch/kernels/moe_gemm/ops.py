"""Entry point of the grouped expert GEMM: `grouped_gemm(x, w)`, the
signature of `repro.kernels.moe_gemm.ops.grouped_gemm` without its TPU-only
`interpret` switch and block sizes.

Kernel: `repro_torch/csrc/moe_gemm.cu`, which replaces the Pallas
`_moe_gemm_kernel` (src/repro/kernels/moe_gemm/moe_gemm.py:21).  Its bf16
decode variant (C <= 8) is a persistent grid over work units of (expert,
columns) that `decode_plan` lays out from the shapes and the card's SM
count.  A CPU tensor takes the plain version in `ref.py`; a CUDA tensor
launches the kernel or raises.  `launches` counts kernel launches."""

from __future__ import annotations

from typing import Iterator, NamedTuple, Tuple

import torch

from repro_torch._device import SM_COUNT, sm_count
from repro_torch.kernels import _build
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

#: Kernel launches made through `grouped_gemm` (the CPU path does not count).
launches = 0

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


def grouped_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[e] = x[e] @ w[e].  x: [E, C, K]; w: [E, K, N], both contiguous and
    of one dtype (fp32 or bf16); K and N multiples of 8 on the card.
    Returns [E, C, N] in x's dtype, accumulated in fp32."""
    global launches
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"grouped_gemm: x on {x.device}, w on {w.device}; "
                         "both must be on one CUDA device")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"grouped_gemm: need x [E, C, K] and w [E, K, N], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"grouped_gemm: x is {x.dtype}, w is {w.dtype}")
    e, c, k = x.shape
    n = w.shape[2]
    if k % 8 or n % 8:
        raise ValueError(f"grouped_gemm: K={k} and N={n} must be multiples "
                         "of 8 (16-byte vectors)")
    if not x.is_contiguous() or not w.is_contiguous() \
            or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("grouped_gemm: x and w must be contiguous and "
                         "16-byte aligned")
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
    launches += 1
    return out
