"""Entry point of the fused RMSNorm: `rmsnorm(x, scale, eps=)`, the
signature of `repro.kernels.rmsnorm.ops.rmsnorm` without its TPU-only
`interpret` switch.

Kernel: `repro_torch/csrc/rmsnorm.cu`, which replaces the Pallas
`_rmsnorm_kernel` (src/repro/kernels/rmsnorm/rmsnorm.py:19).  A CPU
tensor takes the plain version in `ref.py`; a CUDA tensor launches the
kernel or raises.  `launches` counts kernel launches."""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

#: Kernel launches made through `rmsnorm` (the CPU path does not count).
launches = 0


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
    err = _build.load("rmsnorm")(
        x2.data_ptr(), scale.data_ptr(), out.data_ptr(), code,
        x2.shape[0], d, x2.stride(0), float(eps), _build.stream())
    _build.check("rmsnorm", err)
    launches += 1
    return out
