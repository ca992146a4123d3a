"""The port's kernels against the JAX package's.

On this CPU-only host each `repro_torch` kernel wrapper runs its plain
PyTorch version (the version its CUDA kernel is held to on the card), and
each JAX Pallas kernel runs in interpret mode, as tests/test_kernels.py
runs it.  The same numpy inputs go through both.  Tolerances are the
reference's (tests/test_kernels.py): 2e-5 in fp32, 2e-2 in bf16.

tests/test_torch_cuda.py holds the CUDA kernels to these plain versions
on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro.models import flash as jax_models_flash
from repro.models.common import AttnSpec as JaxAttnSpec
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_split_ref)
from repro_torch.kernels.flash_attention import ops as fl_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import flash as torch_models_flash
from repro_torch.models.common import AttnSpec

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU torch tensor of `dtype`
    (bf16 rounding happens once, in JAX, and is carried over exactly)."""
    jdt, tdt, _ = DTYPES[dtype]
    ja = jnp.asarray(a, jdt)
    return ja, torch.from_numpy(np.array(ja, np.float32)).to(tdt)


def _close(t: torch.Tensor, j, tol: float, **kw):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), rtol=tol,
                               atol=tol, **kw)


# --- RMSNorm ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(300, 64), (3, 7, 96), (28, 2048)])
def test_rmsnorm_matches_pallas(dtype, shape):
    rng = np.random.default_rng(sum(shape))
    jx, tx = _pair(rng.standard_normal(shape), dtype)
    js, ts = _pair(0.1 * rng.standard_normal(shape[-1]), dtype)
    before = rms_ops.launches
    out = rms_ops.rmsnorm(tx, ts)
    ref = jax_rmsnorm(jx, js, interpret=True)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _close(out, ref, DTYPES[dtype][2])
    assert rms_ops.launches == before      # the CPU path launches nothing


# --- decode attention ---------------------------------------------------------

DECODE_CASES = [  # (B, KVH, G, S, D, kv_len, kv_start)
    (2, 2, 4, 64, 32, [64, 40], [0, 5]),
    (3, 1, 3, 96, 64, [17, 96, 1], [3, 0, 0]),
    (1, 4, 2, 33, 16, 33, 0),
    (4, 2, 1, 128, 32, [128, 100, 64, 9], [0, 63, 1, 8]),
    (2, 8, 4, 48, 64, [20, 48], None),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_matches_pallas(dtype, case):
    b, kvh, g, s, d, kv_len, kv_start = case
    rng = np.random.default_rng(b * 100 + s)
    jq, tq = _pair(rng.standard_normal((b, kvh * g, d)), dtype)
    jk, tk = _pair(rng.standard_normal((b, s, kvh, d)), dtype)
    jv, tv = _pair(rng.standard_normal((b, s, kvh, d)), dtype)
    lens = np.broadcast_to(np.asarray(kv_len, np.int32), (b,))
    starts = None if kv_start is None else np.broadcast_to(
        np.asarray(kv_start, np.int32), (b,))
    ref = jax_decode(jq, jk, jv, jnp.asarray(lens),
                     None if starts is None else jnp.asarray(starts),
                     block_kv=s if s % 32 else 32, interpret=True)
    out = dec_ops.decode_attention(
        tq, tk, tv, torch.from_numpy(lens.copy()),
        None if starts is None else torch.from_numpy(starts.copy()))
    assert out.shape == (b, kvh * g, d) and out.dtype == tq.dtype
    _close(out, ref, DTYPES[dtype][2])


# (B, KVH, G, S, D, kv_len, kv_start, split_len): a split wholly outside
# the window, a window inside one split, kv_start past the first split,
# lengths 1 and S, a short last split.
SPLIT_CASES = [
    (2, 2, 2, 96, 32, [40, 96], [0, 64], 32),
    (2, 1, 4, 128, 32, [60, 45], [34, 40], 32),
    (2, 2, 1, 128, 16, [1, 128], [0, 0], 32),
    (3, 1, 2, 100, 32, [100, 70, 99], [0, 65, 33], 32),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_decode_attention_split_ref_matches_pallas(dtype, case):
    """The split kernel's two-pass algebra against the one-pass plain
    version and the Pallas kernel in interpret mode."""
    b, kvh, g, s, d, kv_len, kv_start, split_len = case
    n_splits = -(-s // split_len)
    rng = np.random.default_rng(b * 1000 + s + split_len)
    jq, tq = _pair(rng.standard_normal((b, kvh * g, d)), dtype)
    jk, tk = _pair(rng.standard_normal((b, s, kvh, d)), dtype)
    jv, tv = _pair(rng.standard_normal((b, s, kvh, d)), dtype)
    lens, starts = np.asarray(kv_len, np.int32), np.asarray(kv_start,
                                                            np.int32)
    ref = jax_decode(jq, jk, jv, jnp.asarray(lens), jnp.asarray(starts),
                     block_kv=s if s % 32 else 32, interpret=True)
    tl, ts = torch.from_numpy(lens.copy()), torch.from_numpy(starts.copy())
    out = decode_attention_split_ref(
        tq, tk, tv, tl, ts, n_splits=n_splits, split_len=split_len)
    assert out.shape == (b, kvh * g, d) and out.dtype == tq.dtype
    _close(out, ref, DTYPES[dtype][2])
    _close(out, dec_ops.decode_attention_ref(tq, tk, tv, tl, ts).float(),
           DTYPES[dtype][2])


def test_decode_attention_split_ref_empty_window_gives_zero():
    """A window with no key gives 0 in both plain versions (the port's
    convention; the Pallas kernel gives the mean of the values)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((2, 4, 32), (2, 96, 2, 32), (2, 96, 2, 32)))
    lens, starts = torch.tensor([9, 96]), torch.tensor([9, 50])
    out = decode_attention_split_ref(q, k, v, lens, starts,
                                     n_splits=3, split_len=32)
    ref = dec_ops.decode_attention_ref(q, k, v, lens, starts)
    assert bool((out[0] == 0).all()) and bool((ref[0] == 0).all())
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("batch", [1, 4, 12, 20, 28])
def test_split_plan_at_the_paths_and_a_long_cache(batch):
    """One split (one launch a call) on the engine paths' 128-slot caches
    at every batch arm, llama's and olmoe's heads.  At 4096 slots, splits
    of at least 256 keys that cover the cache, and as many as fit two CTAs
    to each of the H100's 132 SMs: at batch 4, 8 splits (256 CTAs, two
    waves)."""
    for kvh in (8, 16):
        assert dec_ops.split_plan(batch, kvh, 128) == (1, 128)
    n, length = dec_ops.split_plan(batch, 8, 4096)
    assert (n - 1) * length < 4096 <= n * length
    if n > 1:
        assert length >= dec_ops.MIN_SPLIT_KEYS and length % 64 == 0
        assert batch * 8 * n <= 2 * dec_ops.SM_COUNT
    assert batch * 8 * (n + 1) > 2 * dec_ops.SM_COUNT or n == 4096 // 256
    if batch == 4:
        assert (n, length) == (8, 512)


def test_decode_attention_reads_cache_slices_in_place():
    """A layer's cache is a strided slice of the stacked [L, B, S, KVH, D]
    cache; the result must not depend on the copy."""
    rng = np.random.default_rng(3)
    cache = torch.from_numpy(rng.standard_normal((2, 2, 24, 2, 16))
                             .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    k = cache[1].transpose(0, 1).contiguous().transpose(0, 1)  # odd strides
    out = dec_ops.decode_attention(q, k, cache[0], 20, 2)
    ref = dec_ops.decode_attention(q, k.contiguous(), cache[0].contiguous(),
                                   20, 2)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


# --- prefill (flash) attention -------------------------------------------------

FLASH_CASES = [  # (B, S, KVH, G, D, causal, window, softcap)
    (1, 64, 2, 2, 32, True, 0, 0.0),
    (2, 96, 1, 3, 32, False, 0, 0.0),
    (1, 128, 2, 2, 32, True, 32, 0.0),
    (2, 64, 2, 1, 64, True, 0, 30.0),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_pallas(dtype, case):
    b, s, kvh, g, d, causal, window, softcap = case
    rng = np.random.default_rng(s + g)
    jq, tq = _pair(rng.standard_normal((b, s, kvh * g, d)), dtype)
    jk, tk = _pair(rng.standard_normal((b, s, kvh, d)), dtype)
    jv, tv = _pair(rng.standard_normal((b, s, kvh, d)), dtype)
    ref = jax_flash(jq, jk, jv, causal=causal, window=window,
                    softcap=softcap, block_q=32, block_kv=32,
                    interpret=True)
    out = fl_ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                 softcap=softcap)
    assert out.shape == (b, s, kvh * g, d)
    _close(out, ref, DTYPES[dtype][2])


def _left_pad_case(seed, b=3, s=16, kvh=2, g=4, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, kvh * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    pads = np.array([5, 0, 11][:b])
    valid = np.arange(s)[None, :] >= pads[:, None]
    return q, k, v, pads, valid


def test_flash_left_pad_matches_blocked_reference():
    """The kernel's plain version with a per-row `kv_start` equals JAX's
    models/flash with the left-pad `kv_valid` on every real query row;
    pad query rows (no valid key) are finite and 0."""
    q, k, v, pads, valid = _left_pad_case(0)
    spec = JaxAttnSpec(d_model=128, n_heads=8, n_kv_heads=2, head_dim=16)
    ref = np.asarray(jax_models_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), spec, causal=True,
        kv_valid=jnp.asarray(valid))).reshape(q.shape)
    out = fl_ops.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_start=torch.from_numpy(pads.astype(np.int32))).numpy()
    assert np.isfinite(out).all()
    for i, p in enumerate(pads):
        np.testing.assert_allclose(out[i, p:], ref[i, p:], rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_array_equal(out[i, :p], 0.0)


@pytest.mark.parametrize("block_kv", [512, 5])
def test_blocked_reference_matches_jax(block_kv):
    """The port of models/flash.py equals JAX's on every row, pad rows
    included (their finite mean-of-values value)."""
    q, k, v, _, valid = _left_pad_case(1)
    jspec = JaxAttnSpec(d_model=128, n_heads=8, n_kv_heads=2, head_dim=16)
    tspec = AttnSpec(d_model=128, n_heads=8, n_kv_heads=2, head_dim=16)
    ref = jax_models_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jspec,
        block_kv=block_kv, kv_valid=jnp.asarray(valid))
    out = torch_models_flash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tspec,
        block_kv=block_kv, kv_valid=torch.from_numpy(valid))
    assert torch.isfinite(out).all()
    _close(out, ref, 2e-5)


# --- wrapper contract --------------------------------------------------------------

def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device never
    reaches a plain version or a kernel."""
    x = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(x, torch.empty(64, device="meta"))
    q = torch.empty((2, 4, 32), device="meta")
    kv = torch.empty((2, 8, 2, 32), device="meta")
    with pytest.raises(ValueError):
        dec_ops.decode_attention(q, kv, kv, 8)
    with pytest.raises(ValueError):
        fl_ops.flash_attention(q[:, None], kv, kv)
