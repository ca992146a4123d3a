"""Plain PyTorch grouped expert GEMM and its backward: the CPU paths of
`ops.grouped_gemm`, `ops.grouped_gemm_dx` and `ops.grouped_gemm_dw` and the
oracles their CUDA kernels are held to on the card.  The product of
`repro.kernels.moe_gemm.ref.moe_gemm_ref`, accumulated in fp32, and its
gradients as autograd takes them through it."""

from __future__ import annotations

import torch


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: [E, C, K]; w: [E, K, N] -> [E, C, N] in x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def moe_gemm_dx_ref(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx[e] = dy[e] @ w[e]^T: dy [E, C, N], w [E, K, N] -> [E, C, K] in
    dy's dtype, accumulated in fp32 (x's gradient through moe_gemm_ref)."""
    return torch.einsum("ecf,edf->ecd", dy.float(), w.float()).to(dy.dtype)


def moe_gemm_dw_ref(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dw[e] = x[e]^T @ dy[e]: x [E, C, K], dy [E, C, N] -> [E, K, N] in
    x's dtype, accumulated in fp32 (w's gradient through moe_gemm_ref)."""
    return torch.einsum("ecd,ecf->edf", x.float(), dy.float()).to(x.dtype)
