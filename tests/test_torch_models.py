"""The port's llama model against the JAX package's, on the CPU.

JAX initialises `llama3.2-1b-smoke` (2 layers, d_model 64); the port
loads the same weights through `params_from_jax`.  Model-level parity is
in fp32 (`dataclasses.replace(cfg, dtype=float32)`) at 1e-4, the
reference's flash-vs-naive tolerance (tests/test_models_decode_equiv.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro_torch.configs as torch_configs
from repro.models import common as jax_common
from repro.models.registry import bundle_for as jax_bundle_for
from repro_torch.models import common
from repro_torch.models.registry import bundle_for
from repro_torch.models.transformer import params_from_jax

ARCH = "llama3.2-1b"
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 32


def _models(attn_impl: str):
    jcfg = dataclasses.replace(jax_configs.get_smoke(ARCH),
                               dtype=jnp.float32, attn_impl=attn_impl)
    tcfg = dataclasses.replace(torch_configs.get_smoke(ARCH),
                               dtype=torch.float32, attn_impl=attn_impl)
    jb = jax_bundle_for(jcfg)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jb, jparams, bundle_for(tcfg), tparams


def _ragged_batch(vocab: int, seed: int = 0):
    """Three left-padded prompts of lengths 9, 5 and 1 (padded to 9)."""
    rng = np.random.default_rng(seed)
    lens = [9, 5, 1]
    toks = np.zeros((3, 9), np.int32)
    mask = np.zeros((3, 9), bool)
    for i, n in enumerate(lens):
        toks[i, 9 - n:] = rng.integers(1, vocab, n)
        mask[i, 9 - n:] = True
    return toks, mask


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_config_matches_reference():
    for get in ("get", "get_smoke"):
        j = getattr(jax_configs, get)(ARCH)
        t = getattr(torch_configs, get)(ARCH)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "rope_theta",
                  "tie_embeddings", "attn_impl", "max_seq_len"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        assert t.n_params == j.n_params
        assert t.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
    assert torch_configs.get(ARCH).n_params == 1_235_812_352


def test_params_from_jax_keeps_keys_and_layout():
    jb, jparams, tb, tparams = _models("naive")
    assert set(tparams) == set(jparams)
    assert len(tparams["layers"]) == tb.cfg.n_layers
    for i, lp in enumerate(tparams["layers"]):
        flat_t = jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda a: a.numpy(), lp))
        for path, leaf in flat_t:
            ref = jparams["layers"]
            for k in path:
                ref = ref[k.key]
            np.testing.assert_array_equal(leaf, np.asarray(ref[i]))
    wq = tparams["layers"][0]["attn"]["wq"]
    assert tuple(wq.shape) == (tb.cfg.d_model,
                               tb.cfg.n_heads * tb.cfg.head_dim)


def test_bf16_weights_cross_exactly():
    """bf16 JAX arrays (ml_dtypes in numpy) load bit-exactly."""
    jcfg = jax_configs.get_smoke(ARCH)
    jparams = jax_bundle_for(jcfg).init_params(jax.random.PRNGKey(1))
    tparams = params_from_jax(torch_configs.get_smoke(ARCH),
                              jax.tree.map(np.asarray, jparams),
                              device="cpu")
    emb = tparams["embedding"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.float().numpy(), np.asarray(jparams["embedding"], np.float32))


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_forward_logits_match_jax(attn_impl):
    jb, jparams, tb, tparams = _models(attn_impl)
    toks = np.random.default_rng(2).integers(1, 256, (2, 12)).astype(
        np.int32)
    jl, _ = jb.forward(jparams, jnp.asarray(toks))
    tl, _ = tb.forward(tparams, torch.from_numpy(toks))
    _close(tl, jl)


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_prefill_and_decode_match_jax(attn_impl):
    """A ragged left-padded prefill and 4 decode steps, fed the same
    tokens, give the JAX logits within 1e-4 at every step."""
    jb, jparams, tb, tparams = _models(attn_impl)
    toks, mask = _ragged_batch(tb.cfg.vocab_size)
    jcache = jb.init_cache(3, MAX_LEN)
    tcache = tb.init_cache(3, MAX_LEN, "cpu")
    jl, jcache = jb.prefill(jparams, jnp.asarray(toks), jcache,
                            attn_mask=jnp.asarray(mask))
    tl, tcache = tb.prefill(tparams, torch.from_numpy(toks), tcache,
                            attn_mask=torch.from_numpy(mask))
    _close(tl, jl)
    dmask = np.ones((3, MAX_LEN), bool)
    dmask[:, :9] = mask
    for i in range(4):
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        jl, jcache = jb.decode_step(jparams, jnp.asarray(tok), jcache,
                                    jnp.asarray(9 + i, jnp.int32),
                                    attn_mask=jnp.asarray(dmask))
        tl, tcache = tb.decode_step(tparams, torch.from_numpy(tok.copy()),
                                    tcache, 9 + i,
                                    attn_mask=torch.from_numpy(dmask))
        _close(tl, jl)
    # Caches agree on every slot a real token wrote.  (Left-pad slots of
    # layers past the first hold the pad rows' attention output, which the
    # kernel route sets to 0 and the reference to a mean; no real token
    # ever reads them.)
    real = dmask[:, :13]
    for name in ("k", "v"):
        np.testing.assert_allclose(
            tcache["global"][name][:, :, :13].numpy()[:, real],
            np.asarray(jcache["global"][name][:, :, :13])[:, real], **TOL)


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_decode_matches_forward(attn_impl):
    """Inside the port: prefill + step-by-step decode reproduces the
    full-sequence forward logits at every position."""
    _, _, tb, tparams = _models(attn_impl)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, 256, (2, 10)).astype(np.int64))
    full, _ = tb.forward(tparams, toks)
    cache = tb.init_cache(2, MAX_LEN, "cpu")
    logits, cache = tb.prefill(tparams, toks[:, :4], cache)
    torch.testing.assert_close(logits, full[:, 3], **TOL)
    for p in range(4, 10):
        logits, cache = tb.decode_step(tparams, toks[:, p], cache, p)
        torch.testing.assert_close(logits, full[:, p], **TOL)


def test_flash_path_matches_naive_path():
    """Inside the port: the kernel route (decode attention + prefill
    attention) gives the naive path's logits on a ragged batch."""
    outs = {}
    for impl in ("naive", "flash"):
        _, _, tb, tparams = _models(impl)
        toks, mask = _ragged_batch(tb.cfg.vocab_size, seed=4)
        cache = tb.init_cache(3, MAX_LEN, "cpu")
        logits, cache = tb.prefill(tparams, torch.from_numpy(toks), cache,
                                   attn_mask=torch.from_numpy(mask))
        steps = [logits]
        dmask = torch.ones((3, MAX_LEN), dtype=torch.bool)
        dmask[:, :9] = torch.from_numpy(mask)
        for i in range(4):
            tok = torch.argmax(steps[-1], dim=-1)
            logits, cache = tb.decode_step(tparams, tok, cache, 9 + i,
                                           attn_mask=dmask)
            steps.append(logits)
        outs[impl] = torch.stack(steps)
    torch.testing.assert_close(outs["flash"], outs["naive"], **TOL)


def test_rope_and_rmsnorm_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 10)[None], (2, 7)).astype(np.int32)
    ref = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    out = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                            500000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    scale = 0.1 * rng.standard_normal(16).astype(np.float32)
    ref = jax_common.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    out = common.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int64)
    labels[0, 1] = -100
    ref = jax_common.cross_entropy_loss(jnp.asarray(logits),
                                        jnp.asarray(labels))
    out = common.cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels))
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-6)


def test_config_takes_what_is_ported():
    cfg = dataclasses.replace(torch_configs.get_smoke(ARCH), qk_norm=True,
                              tie_embeddings=False, attn_impl="flash")
    assert cfg.attn_spec().qk_norm
    params = bundle_for(cfg).init_params(0, "cpu")
    assert "lm_head" in params and "q_norm" in params["layers"][0]["attn"]
    with pytest.raises(ValueError, match="attn_impl"):
        dataclasses.replace(cfg, attn_impl="pallas")


def test_qk_norm_and_untied_head_match_jax():
    """llama3.2-1b-smoke with qk-norm and an untied LM head (olmoe's two
    attention/head features without its MoE) against the JAX model."""
    jcfg = dataclasses.replace(jax_configs.get_smoke(ARCH),
                               dtype=jnp.float32, qk_norm=True,
                               tie_embeddings=False)
    tcfg = dataclasses.replace(torch_configs.get_smoke(ARCH),
                               dtype=torch.float32, qk_norm=True,
                               tie_embeddings=False)
    jb = jax_bundle_for(jcfg)
    jparams = jb.init_params(jax.random.PRNGKey(3))
    # Non-zero norm scales, so a missing or misplaced norm shows.
    rng = np.random.default_rng(3)
    for name in ("q_norm", "k_norm"):
        shape = jparams["layers"]["attn"][name]["scale"].shape
        jparams["layers"]["attn"][name]["scale"] = jnp.asarray(
            0.3 * rng.standard_normal(shape), jnp.float32)
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    toks = rng.integers(1, 256, (2, 9)).astype(np.int32)
    jl, _ = jb.forward(jparams, jnp.asarray(toks))
    tl, _ = bundle_for(tcfg).forward(tparams, torch.from_numpy(toks))
    _close(tl, jl)
