"""Entry point of the grouped expert GEMM: `grouped_gemm(x, w)`, the
signature of `repro.kernels.moe_gemm.ops.grouped_gemm` without its TPU-only
`interpret` switch and block sizes.

Kernel: `repro_torch/csrc/moe_gemm.cu`, which replaces the Pallas
`_moe_gemm_kernel` (src/repro/kernels/moe_gemm/moe_gemm.py:21).  A CPU
tensor takes the plain version in `ref.py`; a CUDA tensor launches the
kernel or raises.  `launches` counts kernel launches."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref

#: Kernel launches made through `grouped_gemm` (the CPU path does not count).
launches = 0


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
    err = _build.load("moe_gemm")(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  code, e, c, k, n, _build.stream())
    _build.check("moe_gemm", err)
    launches += 1
    return out
