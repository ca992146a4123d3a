"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These need a CUDA device and nvcc (the kernels are built from
`src/repro_torch/csrc` at first use) and skip without one.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in fp32, 2e-2 in bf16 (tests/test_kernels.py); the
grouped GEMM, a sum of 1024-2048 products an output, 1e-4 in fp32.
"""

import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fl_ops
from repro_torch.kernels.moe_gemm import ops as mg_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import moe

CUDA_MISSING_REASON = "needs a CUDA device; the kernel has no CPU mode"

DTYPES = {"float32": (torch.float32, 2e-5),
          "bfloat16": (torch.bfloat16, 2e-2)}


@pytest.fixture
def rnd():
    if not torch.cuda.is_available():
        pytest.skip(CUDA_MISSING_REASON)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def make(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).to(dtype)
    return make


def _i32(values):
    return torch.tensor(values, dtype=torch.int32, device="cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_kernel_matches_plain(rnd, dtype):
    dt, tol = DTYPES[dtype]
    before = rms_ops.launches
    for shape in ((28, 16, 2048), (3, 96)):
        x, s = rnd(shape, dt), rnd(shape[-1:], dt, 0.1)
        torch.testing.assert_close(rms_ops.rmsnorm(x, s),
                                   rms_ops.rmsnorm_ref(x, s), rtol=tol,
                                   atol=tol)
    assert rms_ops.launches == before + 2


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_kernel_matches_plain(rnd, dtype):
    dt, tol = DTYPES[dtype]
    q, cache = rnd((4, 32, 64), dt), rnd((2, 3, 4, 128, 8, 64), dt)
    k, v = cache[0, 1], cache[1, 1]          # layer slices, in place
    lens, starts = _i32([128, 90, 17, 64]), _i32([0, 7, 16, 3])
    torch.testing.assert_close(
        dec_ops.decode_attention(q, k, v, lens, starts),
        dec_ops.decode_attention_ref(q, k, v, lens, starts),
        rtol=tol, atol=tol)
    q, kv = rnd((2, 6, 128), dt), rnd((2, 2, 40, 2, 128), dt)
    torch.testing.assert_close(
        dec_ops.decode_attention(q, kv[0], kv[1], 33),
        dec_ops.decode_attention_ref(q, kv[0], kv[1], 33),
        rtol=tol, atol=tol)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_kernel_matches_plain(rnd, dtype):
    dt, tol = DTYPES[dtype]
    q, k, v = rnd((28, 16, 32, 64), dt), rnd((28, 16, 8, 64), dt), \
        rnd((28, 16, 8, 64), dt)
    starts = torch.arange(28, device="cuda", dtype=torch.int32) % 16
    out = fl_ops.flash_attention(q, k, v, kv_start=starts)
    torch.testing.assert_close(
        out, fl_ops.attention_ref(q, k, v, kv_start=starts), rtol=tol,
        atol=tol)
    assert bool(torch.isfinite(out).all())
    q, k, v = rnd((2, 130, 6, 32), dt), rnd((2, 130, 2, 32), dt), \
        rnd((2, 130, 2, 32), dt)
    torch.testing.assert_close(
        fl_ops.flash_attention(q, k, v, window=33, softcap=20.0),
        fl_ops.attention_ref(q, k, v, window=33, softcap=20.0),
        rtol=tol, atol=tol)


@pytest.mark.requires_cuda
def test_wrappers_reject_what_the_kernels_cannot_take(rnd):
    x = rnd((4, 64), torch.float16)
    with pytest.raises(TypeError):
        rms_ops.rmsnorm(x, rnd((64,), torch.float16))
    q, kv = rnd((2, 8, 48), torch.float32), rnd((2, 16, 2, 48),
                                                torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        dec_ops.decode_attention(q, kv, kv, 8)


GEMM_DTYPES = {"float32": (torch.float32, 1e-4),
               "bfloat16": (torch.bfloat16, 2e-2)}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(GEMM_DTYPES))
def test_moe_gemm_kernel_matches_plain(rnd, dtype):
    """Every variant (skinny C <= 8, tile C > 8) with ragged C, K and N
    edges, and olmoe-1b-7b's decode and prefill products."""
    dt, tol = GEMM_DTYPES[dtype]
    before = mg_ops.launches
    shapes = ((3, 5, 40, 48), (2, 33, 32, 48), (4, 96, 64, 64),
              (2, 9, 2056, 136), (1, 1, 8, 8), (5, 70, 24, 200),
              (64, 8, 2048, 1024), (64, 8, 1024, 2048), (64, 224, 2048, 1024))
    for e, c, k, n in shapes:
        x, w = rnd((e, c, k), dt), rnd((e, k, n), dt, k ** -0.5)
        torch.testing.assert_close(mg_ops.grouped_gemm(x, w),
                                   mg_ops.moe_gemm_ref(x, w), rtol=tol,
                                   atol=tol)
    assert mg_ops.launches == before + len(shapes)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_kernels_at_olmoe_geometry(rnd, dtype):
    """16 query heads over 16 KV heads (G = 1) at head_dim 128."""
    dt, tol = DTYPES[dtype]
    q, cache = rnd((28, 16, 128), dt), rnd((2, 28, 128, 16, 128), dt)
    lens = torch.arange(16, 44, device="cuda", dtype=torch.int32)
    starts = torch.arange(28, device="cuda", dtype=torch.int32) % 8
    torch.testing.assert_close(
        dec_ops.decode_attention(q, cache[0], cache[1], lens, starts),
        dec_ops.decode_attention_ref(q, cache[0], cache[1], lens, starts),
        rtol=tol, atol=tol)
    q, k, v = (rnd((28, 16, 16, 128), dt) for _ in range(3))
    torch.testing.assert_close(
        fl_ops.flash_attention(q, k, v, kv_start=starts),
        fl_ops.attention_ref(q, k, v, kv_start=starts), rtol=tol, atol=tol)


@pytest.mark.requires_cuda
def test_moe_apply_on_card_matches_cpu(rnd):
    """The dispatch, the kernel products and the combine on the card give
    the CPU's plain result in fp32 (ample capacity, so no near-tie moves a
    token to another expert)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff=256, capacity_factor=8.0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = moe.moe_init(gen, 128, cfg, torch.float32, "cuda")
    for shape in ((4, 16, 128), (28, 1, 128)):
        x = rnd(shape, torch.float32)
        out, aux = moe.moe_apply(params, cfg, x)
        ref, ref_aux = moe.moe_apply({k: v.cpu() for k, v in params.items()},
                                     cfg, x.cpu())
        torch.testing.assert_close(out.cpu(), ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(aux.cpu(), ref_aux, rtol=0, atol=1e-6)


@pytest.mark.requires_cuda
def test_grouped_gemm_rejects_what_the_kernel_cannot_take(rnd):
    x, w = rnd((2, 4, 12), torch.float32), rnd((2, 12, 16), torch.float32)
    with pytest.raises(ValueError, match="multiples of 8"):
        mg_ops.grouped_gemm(x, w)
    x, w = rnd((2, 4, 16), torch.float32), rnd((2, 16, 16), torch.bfloat16)
    with pytest.raises(TypeError):
        mg_ops.grouped_gemm(x, w)
    with pytest.raises(ValueError, match="contiguous"):
        mg_ops.grouped_gemm(x, rnd((2, 16, 16), torch.float32).transpose(1, 2))
