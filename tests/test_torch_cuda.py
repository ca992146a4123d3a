"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  These need a CUDA device and nvcc (the kernels are built from
`src/repro_torch/csrc` at first use) and skip without one.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in fp32, 2e-2 in bf16 (tests/test_kernels.py).
"""

import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fl_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops

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
