"""Plain PyTorch RMSNorm and its backward: the CPU paths of `ops.rmsnorm`
and `ops.rmsnorm_backward`, and the oracles their CUDA kernels are held to
on the card.  Same arithmetic as `repro.models.common.rmsnorm` with
``unit_offset=True``; the backward is that function's gradient, written
out in fp32."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x: [..., D]; scale: [D].  fp32 math, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_bwd_ref(dy: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                    eps: float = 1e-6):
    """Gradients of `rmsnorm_ref(x, scale, eps)` given dy (x's shape):
    (dx in x's dtype, dscale [D] in scale's dtype).  With r = rsqrt(mean(
    x^2) + eps), xh = x r and g = dy (1 + scale), in fp32:
    dx = r (g - xh mean(g xh)) and dscale = the sum over rows of dy xh."""
    xf, df = x.float(), dy.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xh = xf * r
    g = df * (1.0 + scale.float())
    dx = r * (g - xh * torch.mean(g * xh, dim=-1, keepdim=True))
    dscale = (df * xh).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)

