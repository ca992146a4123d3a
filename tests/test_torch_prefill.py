"""Prefill attention's routing, the per-row tolerance its kernel is held to
on the card, and its plain version against the JAX package's blocked
flash attention at a window and a left-pad start together.

`route` decides from the dtype alone which CUDA kernel a call launches
(bf16: the tensor-core kernel; fp32: the CUDA-core kernel), so it is
tested as a pure function here; tests/test_torch_cuda.py holds both
kernels to `attention_ref` on the card with `row_scaled_error`.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import flash as jax_models_flash
from repro.models.common import AttnSpec as JaxAttnSpec
from repro_torch.kernels.flash_attention import ops as fl_ops
from repro_torch.kernels.flash_attention.ref import (
    attention_ref, row_scaled_error)

TOL_BF16 = 2e-2


@pytest.mark.parametrize("head_dim", fl_ops.HEAD_DIMS)
def test_route_by_dtype(head_dim):
    assert fl_ops.route(torch.bfloat16, head_dim) == "tc"
    assert fl_ops.route(torch.float32, head_dim) == "simt"


def test_route_refuses_what_no_kernel_takes():
    with pytest.raises(TypeError):
        fl_ops.route(torch.float16, 64)
    for head_dim in (16, 48, 80, 192, 512):
        with pytest.raises(ValueError, match="head_dim"):
            fl_ops.route(torch.bfloat16, head_dim)


def _drop_keys(q, k, v, rows, keys):
    """Causal attention in fp32 with keys `keys` left out of query rows
    `rows`: what a kernel that lost one key tile in those rows returns."""
    b, s, h, d = q.shape
    g = h // k.shape[2]
    scores = torch.einsum("bqhd,bshd->bhqs", q / math.sqrt(d),
                          k.repeat_interleave(g, dim=2))
    pos = torch.arange(s)
    keep = pos[None, :] <= pos[:, None]
    keep[rows.start:rows.stop, keys.start:keys.stop] = False
    scores = scores.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqs,bshd->bqhd", torch.softmax(scores, dim=-1),
                        v.repeat_interleave(g, dim=2))


def test_row_scaled_error_catches_a_dropped_tile():
    """One 64-key tile lost from the last 64 rows of a 4000-token prompt
    (llama's head_dim, the long rows' N(0, 1) inputs) moves those rows by
    ~30 % of their own small values (RMS ~0.03), but by 0.015 in absolute
    terms and by 0.7 % of the whole output's max, which is row 0's value
    row of magnitude ~2.4: the per-row check fails it, the absolute and the
    whole-output checks both pass it."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 4000, 1, 64), generator=gen)
               for _ in range(3))
    ref = attention_ref(q, k, v)
    dropped = _drop_keys(q, k, v, rows=slice(3936, 4000), keys=slice(64, 128))
    diff = (dropped - ref).abs().max().item()
    assert row_scaled_error(dropped, ref) > 10 * TOL_BF16
    assert diff <= TOL_BF16
    assert diff <= TOL_BF16 * ref.abs().max().item()
    # Nothing dropped: the same arithmetic gives the reference back.
    full = _drop_keys(q, k, v, rows=slice(0, 0), keys=slice(0, 0))
    assert row_scaled_error(full, ref) < 1e-5


def test_row_scaled_error_holds_empty_rows_to_zero():
    """A row with no valid key is 0 in the reference; only 0 passes."""
    ref = torch.zeros((2, 3, 4, 8))
    ref[1] = 0.5
    out = ref.clone()
    assert row_scaled_error(out, ref) == 0.0
    out[0, 1, 2, 3] = 1e-3
    assert row_scaled_error(out, ref) > TOL_BF16
    out = ref.clone()
    out[1, 0, 0, 0] += 0.005                    # 1 % of that row's 0.5
    assert row_scaled_error(out, ref) == pytest.approx(0.01)


@pytest.mark.parametrize("case", [
    # (S, KVH, G, D, window, softcap, pads)
    (40, 2, 4, 32, 9, 0.0, (0, 5, 17)),
    (64, 1, 2, 64, 24, 30.0, (3, 0, 40)),
])
def test_attention_ref_matches_jax_blocked_flash(case):
    """The kernel's plain version with a window and a per-row kv_start
    (and a softcap) equals JAX's models/flash with the same window and the
    left-pad kv_valid on every real query row; pad rows are 0."""
    s, kvh, g, d, window, softcap, pads = case
    b = len(pads)
    rng = np.random.default_rng(s + g)
    q = rng.standard_normal((b, s, kvh * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    pads = np.asarray(pads)
    valid = np.arange(s)[None, :] >= pads[:, None]
    spec = JaxAttnSpec(d_model=kvh * g * d, n_heads=kvh * g, n_kv_heads=kvh,
                       head_dim=d, logit_softcap=softcap)
    ref = np.asarray(jax_models_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), spec, causal=True,
        block_kv=16, window=window, kv_valid=jnp.asarray(valid))
    ).reshape(q.shape)
    out = fl_ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window=window, softcap=softcap,
        kv_start=torch.from_numpy(pads.astype(np.int32))).numpy()
    assert np.isfinite(out).all()
    for i, p in enumerate(pads):
        np.testing.assert_allclose(out[i, p:], ref[i, p:], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_array_equal(out[i, :p], 0.0)
