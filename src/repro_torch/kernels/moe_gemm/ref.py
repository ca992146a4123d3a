"""Plain PyTorch grouped expert GEMM: the CPU path of `ops.grouped_gemm` and
the oracle its CUDA kernel is held to on the card.  The product of
`repro.kernels.moe_gemm.ref.moe_gemm_ref`, accumulated in fp32."""

from __future__ import annotations

import torch


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [E, C, K]; w: [E, K, N] -> [E, C, N] in x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)
