"""The port's RWKV-6 path (rwkv6-3b) against the JAX package's, on the CPU.

- WKV6: `ops.wkv6` (its plain version on a CPU tensor) against the Pallas
  kernel in interpret mode from a zero state, and against the sequential
  oracle from a nonzero state (which the Pallas kernel ignores), at chunk
  1, 8 and 32; the extreme decay logw = -4 stays finite.  Tolerance rtol
  1e-3 / atol 1e-4, as tests/test_kernels.py holds the Pallas kernel.
- LayerNorm against `repro.models.common.layernorm`.
- rwkv6-smoke in fp32 with JAX's weights (`params_from_jax`; the mixes,
  decay base, bonus and norms, zero at init, are filled with seeded noise
  so every term counts): forward logits, a ragged prefill with a chunked
  head and a per-token tail, and 4 decode steps, within 1e-4; the state
  after prefill; decode from a JAX state (`state_from_jax`).
- decode == forward inside the port; the engine's greedy tokens equal the
  JAX engine's; fused == loop; a reused pooled state equals a fresh one;
  `serve.py`'s engine mode on rwkv6-3b.

Ragged == unpadded is not asserted: the reference folds left pads into the
state, so it does not hold there either.  tests/test_torch_cuda.py holds
the CUDA kernel to the plain version on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro_torch.configs as torch_configs
from repro.kernels.rwkv6.ops import wkv6 as pallas_wkv6
from repro.kernels.rwkv6.ref import wkv6_sequential as jax_wkv6_sequential
from repro.models import common as jax_common
from repro.models.registry import bundle_for as jax_bundle_for
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.kernels.rwkv6 import ops as wk_ops
from repro_torch.launch.serve import engine_mode
from repro_torch.models import common, rwkv6
from repro_torch.models.registry import bundle_for
from repro_torch.serving.engine import InferenceEngine

ARCH = "rwkv6-3b"
KERNEL_TOL = dict(rtol=1e-3, atol=1e-4)
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 48


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


# --- WKV6 -------------------------------------------------------------------

def _wkv_inputs(b, s, h, n, seed, state_scale=0.0):
    """The recipe of tests/test_kernels.py's WKV6 sweep, from numpy."""
    rng = np.random.default_rng(seed)
    r = 0.5 * rng.standard_normal((b, s, h, n))
    k = 0.5 * rng.standard_normal((b, s, h, n))
    v = rng.standard_normal((b, s, h, n))
    logw = np.clip(-np.exp(rng.standard_normal((b, s, h, n)) - 2.0), -4.0,
                   -1e-6)
    u = 0.2 * rng.standard_normal((h, n))
    st = state_scale * rng.standard_normal((b, h, n, n))
    return [np.asarray(a, np.float32) for a in (r, k, v, logw, u, st)]


def _port_wkv6(arrays, chunk):
    r, k, v, logw, u, st = (_t(a) for a in arrays)
    before = wk_ops.launches
    y, out = wk_ops.wkv6(r, k, v, logw, u, st, chunk=chunk)
    assert out is st                       # the state is updated in place
    assert y.dtype == torch.float32 and y.shape == r.shape
    assert wk_ops.launches == before       # the CPU path launches nothing
    return y.numpy(), out.numpy()


@pytest.mark.parametrize("chunk", [1, 8, 32])
def test_wkv6_matches_pallas_interpret(chunk):
    arrays = _wkv_inputs(2, 32, 2, 16, seed=chunk)
    y, st = _port_wkv6(arrays, chunk)
    jy, jst = pallas_wkv6(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                          interpret=True)
    np.testing.assert_allclose(y, np.asarray(jy), **KERNEL_TOL)
    np.testing.assert_allclose(st, np.asarray(jst), **KERNEL_TOL)


@pytest.mark.parametrize("chunk", [1, 8, 32])
def test_wkv6_honours_the_initial_state(chunk):
    """From a nonzero state: the port against the sequential oracle (the
    Pallas kernel would compute from zero), and the port's own oracle and
    one-token step against the JAX oracle."""
    arrays = _wkv_inputs(2, 32, 2, 16, seed=10 + chunk, state_scale=0.5)
    jy, jst = jax_wkv6_sequential(*(jnp.asarray(a) for a in arrays))
    y, st = _port_wkv6(arrays, chunk)
    np.testing.assert_allclose(y, np.asarray(jy), **KERNEL_TOL)
    np.testing.assert_allclose(st, np.asarray(jst), **KERNEL_TOL)
    sy, sst = wk_ops.wkv6_sequential(*(_t(a) for a in arrays))
    np.testing.assert_allclose(sy.numpy(), np.asarray(jy), **KERNEL_TOL)
    np.testing.assert_allclose(sst.numpy(), np.asarray(jst), **KERNEL_TOL)
    one = [a[:, :1] for a in arrays[:4]] + arrays[4:]
    jy1, jst1 = jax_wkv6_sequential(*(jnp.asarray(a) for a in one))
    y1, st1 = _port_wkv6(one, 1)
    np.testing.assert_allclose(y1, np.asarray(jy1), **KERNEL_TOL)
    np.testing.assert_allclose(st1, np.asarray(jst1), **KERNEL_TOL)


def test_wkv6_extreme_decay_stays_finite():
    b, s, h, n = 1, 64, 1, 16
    r = np.full((b, s, h, n), 0.5, np.float32)
    v = np.ones((b, s, h, n), np.float32)
    logw = np.full((b, s, h, n), -4.0, np.float32)
    arrays = [r, r.copy(), v, logw, np.zeros((h, n), np.float32),
              np.zeros((b, h, n, n), np.float32)]
    y, st = _port_wkv6(arrays, 32)
    assert np.isfinite(y).all() and np.isfinite(st).all()
    jy, jst = jax_wkv6_sequential(*(jnp.asarray(a) for a in arrays))
    np.testing.assert_allclose(y, np.asarray(jy), **KERNEL_TOL)
    np.testing.assert_allclose(st, np.asarray(jst), **KERNEL_TOL)


def test_layernorm_matches_reference():
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((3, 5, 64)) + 1.0).astype(np.float32)
    p = {"scale": 0.1 * rng.standard_normal(64).astype(np.float32),
         "bias": 0.1 * rng.standard_normal(64).astype(np.float32)}
    ref = jax_common.layernorm({k: jnp.asarray(a) for k, a in p.items()},
                               jnp.asarray(x))
    out = common.layernorm({k: _t(a) for k, a in p.items()}, _t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    bf = common.layernorm({k: _t(a).bfloat16() for k, a in p.items()},
                          _t(x).bfloat16())
    assert bf.dtype == torch.bfloat16
    np.testing.assert_allclose(bf.float().numpy(), np.asarray(ref),
                               rtol=2e-2, atol=2e-2)


# --- the model ----------------------------------------------------------------

#: Leaves the reference initialises to zero (or to a constant), filled with
#: seeded noise so that the mixes, the decay base, the bonus and the norms
#: all reach the outputs; the decay base wide enough to hit both clips.
_NOISE = {"maa_x": 0.3, "maa_rkvwg": 0.3, "maa_k": 0.3, "maa_r": 0.3,
          "decay_base": 2.5, "bonus": 0.5, "scale": 0.1, "bias": 0.1}


def _noisy(tree, rng, key=None):
    if isinstance(tree, dict):
        return {k: _noisy(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if key in _NOISE:
        a = a + _NOISE[key] * rng.standard_normal(a.shape).astype(np.float32)
    return jnp.asarray(a, tree.dtype)


def _models(dtype=torch.float32, seed=0):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = dataclasses.replace(jax_configs.get_smoke(ARCH), dtype=jdt)
    tcfg = dataclasses.replace(torch_configs.get_smoke(ARCH), dtype=dtype)
    jb = jax_bundle_for(jcfg)
    jparams = _noisy(jb.init_params(jax.random.PRNGKey(seed)),
                     np.random.default_rng(seed))
    tparams = rwkv6.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return jb, jparams, bundle_for(tcfg), tparams


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def _ragged(lengths, plen, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), plen), np.int32)
    mask = np.zeros((len(lengths), plen), bool)
    for i, n in enumerate(lengths):
        toks[i, plen - n:] = rng.integers(1, 256, n)
        mask[i, plen - n:] = True
    return toks, mask


def test_config_matches_reference():
    for get in ("get", "get_smoke"):
        j = getattr(jax_configs, get)(ARCH)
        t = getattr(torch_configs, get)(ARCH)
        for f in ("name", "n_layers", "d_model", "head_dim", "n_heads",
                  "d_ff", "vocab_size", "lora_rank_decay", "lora_rank_mix",
                  "chunk", "tie_embeddings", "remat", "max_seq_len"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        assert t.n_params == j.n_params
        assert t.n_active_params == j.n_active_params
    assert torch_configs.get(ARCH).n_params == 3_099_688_960
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(torch_configs.get_smoke(ARCH), remat="full")


def test_params_from_jax_and_init_params_make_the_reference_tree():
    jb, jparams, tb, tparams = _models(dtype=torch.bfloat16)
    def shapes(tree):
        return jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda a: tuple(a.shape), tree,
                         is_leaf=lambda a: hasattr(a, "shape")),
            is_leaf=lambda x: isinstance(x, tuple))[0]

    ref = [(path, s[1:]) for path, s in shapes(jparams["layers"])]
    for params in (tparams, tb.init_params(0, "cpu")):
        assert set(params) == set(jparams) == {
            "embedding", "ln0", "layers", "final_norm", "lm_head"}
        assert len(params["layers"]) == tb.cfg.n_layers
        assert shapes(params["layers"][1]) == ref
        assert {a.dtype for a in jax.tree.leaves(params["layers"])} == {
            torch.bfloat16}
    np.testing.assert_array_equal(
        tparams["layers"][1]["time_mix"]["bonus"].float().numpy(),
        np.asarray(jparams["layers"]["time_mix"]["bonus"][1], np.float32))


def test_forward_logits_match_jax():
    """S = 13 is right-padded to 16 (two chunks of 8), as in the
    reference."""
    jb, jparams, tb, tparams = _models()
    toks = np.random.default_rng(2).integers(1, 256, (3, 13)).astype(
        np.int32)
    jl, _ = jb.forward(jparams, jnp.asarray(toks))
    tl, aux = tb.forward(tparams, torch.from_numpy(toks))
    _close(tl, jl)
    assert float(aux) == 0.0


def test_prefill_with_tail_and_decode_match_jax():
    """A ragged left-padded prompt bucketed to 12 at chunk 8: one chunked
    pass over 8 tokens and 4 single-token steps, then 4 decode steps fed
    the same tokens; the logits and the state agree with JAX's."""
    jb, jparams, tb, tparams = _models()
    toks, mask = _ragged([12, 7, 3], 12, seed=0)
    jcache = jb.init_cache(3, MAX_LEN)
    tcache = tb.init_cache(3, MAX_LEN, "cpu")
    before = wk_ops.launches
    jl, jcache = jb.prefill(jparams, jnp.asarray(toks), jcache,
                            attn_mask=jnp.asarray(mask))
    tl, tcache = tb.prefill(tparams, torch.from_numpy(toks), tcache,
                            attn_mask=torch.from_numpy(mask))
    _close(tl, jl)
    for key in ("tm_shift", "cm_shift", "wkv"):
        _close(tcache[key], jcache[key])
    for i in range(4):
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        jl, jcache = jb.decode_step(jparams, jnp.asarray(tok), jcache,
                                    jnp.asarray(12 + i, jnp.int32))
        tl, tcache = tb.decode_step(tparams, torch.from_numpy(tok.copy()),
                                    tcache, 12 + i)
        _close(tl, jl)
    _close(tcache["wkv"], jcache["wkv"])
    assert wk_ops.launches == before


def test_state_from_jax_continues_a_jax_prefill():
    jb, jparams, tb, tparams = _models()
    toks, _ = _ragged([9, 9], 9, seed=5)
    jl, jstate = jb.prefill(jparams, jnp.asarray(toks),
                            jb.init_cache(2, MAX_LEN))
    state = rwkv6.state_from_jax(tb.cfg, jax.tree.map(np.asarray, jstate),
                                 device="cpu")
    assert state["wkv"].dtype == torch.float32
    assert tuple(state["wkv"].shape) == (2, 2, 4, 16, 16)
    tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
    jl, _ = jb.decode_step(jparams, jnp.asarray(tok), jstate,
                           jnp.asarray(9, jnp.int32))
    tl, _ = tb.decode_step(tparams, torch.from_numpy(tok.copy()), state, 9)
    _close(tl, jl)


def test_decode_matches_forward():
    """Inside the port, as tests/test_models_decode_equiv.py: prefill of 7
    tokens (all tail at chunk 8) and step-by-step decode reproduce the
    teacher-forced forward logits."""
    _, _, tb, tparams = _models()
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, 256, (2, 12)).astype(np.int64))
    full, _ = tb.forward(tparams, toks)
    for prompt in (7, 8):               # all tail; one whole chunk
        cache = tb.init_cache(2, MAX_LEN, "cpu")
        logits, cache = tb.prefill(tparams, toks[:, :prompt], cache)
        torch.testing.assert_close(logits, full[:, prompt - 1], **TOL)
        for p in range(prompt, 12):
            logits, cache = tb.decode_step(tparams, toks[:, p], cache, p)
            torch.testing.assert_close(logits, full[:, p], **TOL)


# --- the engine ---------------------------------------------------------------

def _engine(bundle, params, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_seq_len", MAX_LEN)
    return InferenceEngine(bundle, params, device="cpu", **kw)


def _prompts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, size=n).astype(np.int32) for n in lengths]


def test_greedy_tokens_match_jax_engine():
    """Same fp32 weights, same ragged prompts (bucketed to 16 and 32, so
    prefill runs whole chunks; 20 with bucket 4 adds a per-token tail):
    the port's engine gives the JAX engine's greedy token stream."""
    jb, jparams, tb, tparams = _models()
    for lengths, bucket in (([5, 9, 7, 16, 1], 16), ([20, 3], 4),
                            ([17, 2, 30], 16)):
        prompts = _prompts(lengths, seed=len(lengths) + bucket)
        ref, _ = JaxEngine(jb, jparams, max_batch=8, max_seq_len=MAX_LEN,
                           prompt_bucket=bucket).generate(prompts, 10)
        out, _ = _engine(tb, tparams, prompt_bucket=bucket).generate(
            prompts, 10)
        np.testing.assert_array_equal(out, ref)


def test_fused_bit_identical_to_loop():
    _, _, tb, tp = _models(torch.bfloat16)
    prompts = _prompts([5, 9, 7], seed=0)
    out_f, st_f = _engine(tb, tp, decode_impl="fused").generate(prompts, 8)
    out_l, st_l = _engine(tb, tp, decode_impl="loop").generate(prompts, 8)
    np.testing.assert_array_equal(out_f, out_l)
    assert out_f.shape == (3, 8) and out_f.dtype == np.int32
    assert st_f.decode_impl == "fused" and st_l.decode_impl == "loop"


def test_pooled_cache_reuse_equals_fresh_engine():
    """The state is updated in place in the pooled buffer; a second
    generate at the same batch must still start from zero and give a
    fresh engine's tokens."""
    _, _, tb, tp = _models()
    eng = _engine(tb, tp, prompt_bucket=4)
    eng.generate(_prompts([15, 11, 13], seed=3), 12)
    assert float(eng._cache_pool[3]["wkv"].abs().sum()) > 0
    second = _prompts([3, 6, 2], seed=4)
    reused, _ = eng.generate(second, 9)
    fresh, _ = _engine(tb, tp, prompt_bucket=4).generate(second, 9)
    np.testing.assert_array_equal(reused, fresh)
    assert eng.compile_counts["cache_pool"] == 1


def test_serve_engine_mode_runs_rwkv6():
    out = engine_mode(ARCH, rounds=2, alpha=0.5, seed=0, device="cpu")
    assert out["total_tokens"] > 0 and out["energy_per_req"] > 0
