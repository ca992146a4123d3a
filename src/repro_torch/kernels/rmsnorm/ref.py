"""Plain PyTorch RMSNorm: the CPU path of `ops.rmsnorm` and the oracle its
CUDA kernel is held to on the card.  Same arithmetic as
`repro.models.common.rmsnorm` with ``unit_offset=True``."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; scale: [D].  fp32 math, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)
