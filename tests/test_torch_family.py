"""The rest of the transformer family in the port against the JAX package,
on the CPU: qwen2-1.5b and qwen2.5-3b (q/k/v biases), smollm-360m,
starcoder2-7b (LayerNorm, biases, dense GELU MLP), gemma2-27b (local/global
interleave with a ring-cached window, attention and final softcaps,
post-norms, sqrt(d) embedding scale, query scale), phi-3-vision-4.2b (a
prefix of patch embeddings) and mixtral-8x22b (MoE over ring-cached local
layers), and the int8 KV cache.

Smoke configs only, in fp32: seeded weights in the reference's params
tree, which JAX runs and the port loads through `params_from_jax`.  Both
initialise biases and norm scales to zero, so they are filled with seeded
noise first, in that tree, so a missing or misplaced one shows.  The
port's naive and flash paths are both held to the reference's naive one
(the plain version), each run of it made once.  Tolerance: 1e-4, the
reference's flash-vs-naive tolerance (tests/test_models_decode_equiv.py);
the int8 quantizer is held bit for bit.  The smoke rings hold 8 slots and
the caches 32, so the prefill (9 tokens) rolls the ring and the decode
steps wrap it.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro_torch.configs as torch_configs
from repro.models import common as jax_common
from repro.models import transformer as jax_transformer
from repro.models.registry import bundle_for as jax_bundle_for
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.scheduler import EngineRequest as JaxRequest
from repro_torch.models import common, transformer
from repro_torch.models.frontends import AudioStub, VisionStub
from repro_torch.models.registry import bundle_for
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.scheduler import EngineRequest

ARCHS = ("qwen2-1.5b", "qwen2.5-3b", "smollm-360m", "starcoder2-7b",
         "gemma2-27b", "phi-3-vision-4.2b", "mixtral-8x22b")
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 32
#: Leaves the reference initialises to zero (biases, norm scales, the
#: LayerNorm bias), given noise of this scale.
NOISE = {"bq": 0.3, "bk": 0.3, "bv": 0.3, "bo": 0.1, "b_in": 0.1,
         "b_out": 0.1, "b_gate": 0.1, "b_up": 0.1, "b_down": 0.1,
         "scale": 0.2, "bias": 0.1}


def _noisy(tree, rng, key=None):
    if isinstance(tree, dict):
        return {k: _noisy(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if key in NOISE:
        a = a + NOISE[key] * rng.standard_normal(a.shape).astype(np.float32)
    return a


@functools.lru_cache(maxsize=None)
def _reference(arch, kv="native"):
    """The JAX bundle with the KV cache of `kv` and naive attention (the
    plain reference, which the port's naive and flash paths are both held
    to), its params, and its forward, prefill and decode step, each
    compiled once (run eagerly, each call would trace its layer scan
    anew).  Made once and shared: no test writes params."""
    jcfg = dataclasses.replace(jax_configs.get_smoke(arch), dtype=jnp.float32,
                               attn_impl="naive", kv_cache_dtype=kv)
    jb = jax_bundle_for(jcfg)
    jparams = jax.tree.map(jnp.asarray, _tree(arch))
    return jb, jparams, (jax.jit(jb.forward), jax.jit(jb.prefill),
                         jax.jit(jb.decode_step))


def _numpy(tree):
    """A params tree as fp32 numpy, a list of per-layer trees stacked into
    the reference's `[layers, ...]` leaves."""
    if isinstance(tree, list):
        return jax.tree.map(lambda *leaves: np.stack(leaves),
                            *[_numpy(lp) for lp in tree])
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.float().numpy()


@functools.lru_cache(maxsize=None)
def _tree(arch):
    """Seeded fp32 weights of `arch`'s smoke config as the reference's
    params tree: the port's own init (the reference's leaves and shapes,
    `test_init_params_makes_the_reference_tree`), stacked, with noise on
    the leaves both set to zero (the same for every cache type)."""
    tcfg = dataclasses.replace(torch_configs.get_smoke(arch),
                               dtype=torch.float32)
    return _noisy(_numpy(transformer.init_params(tcfg, 0, "cpu")),
                  np.random.default_rng(1))


@functools.lru_cache(maxsize=None)
def _models(arch, attn_impl="naive", kv="native"):
    """The JAX reference (`_reference`) and the port's bundle of
    `attn_impl` with the same params and KV cache type."""
    jb, jparams, _ = _reference(arch, kv)
    tcfg = dataclasses.replace(torch_configs.get_smoke(arch),
                               dtype=torch.float32, attn_impl=attn_impl,
                               kv_cache_dtype=kv)
    tb = bundle_for(tcfg)
    return jb, jparams, tb, transformer.params_from_jax(tcfg, _tree(arch),
                                                        device="cpu")


def _drawn(init, rng):
    """Seeded draws, 0.2 N(0, 1) in fp32 numpy, in the leaves and shapes
    of the reference's `init()` tree (traced, not run)."""
    return jax.tree.map(
        lambda a: (0.2 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.eval_shape(init))


def _ragged_batch(vocab=256, lens=(9, 5, 1), seed=0):
    """Left-padded prompts of `lens`, padded to the longest."""
    rng = np.random.default_rng(seed)
    s = max(lens)
    toks = np.zeros((len(lens), s), np.int32)
    mask = np.zeros((len(lens), s), bool)
    for i, n in enumerate(lens):
        toks[i, s - n:] = rng.integers(1, vocab, n)
        mask[i, s - n:] = True
    return toks, mask


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    """Every field the port keeps equals the reference's, for the full and
    the smoke config, and so do the parameter counts."""
    for get in ("get", "get_smoke"):
        j = getattr(jax_configs, get)(arch)
        t = getattr(torch_configs, get)(arch)
        for f in dataclasses.fields(t):
            if f.name in ("dtype", "moe"):
                continue
            assert getattr(t, f.name) == getattr(j, f.name), (get, f.name)
        assert (t.moe is None) == (j.moe is None)
        if t.moe is not None:
            for f in dataclasses.fields(t.moe):
                assert getattr(t.moe, f.name) == getattr(j.moe, f.name)
        assert t.is_local == j.is_local
        assert (t.n_params, t.n_active_params) == \
            (j.n_params, j.n_active_params)


def test_edge_models_and_aliases_follow_the_reference():
    """The port has the paper's two edge models, and every alias of the
    reference."""
    for name in jax_configs.EDGE_MODELS:
        assert torch_configs.get(name).name == jax_configs.get(name).name
    ported = set(torch_configs.ALIASES)
    assert ported == set(jax_configs.ALIASES)
    for alias in ported:
        assert torch_configs.ALIASES[alias] == jax_configs.ALIASES[alias]


def test_full_configs_fit_or_say_they_do_not():
    """gemma2-27b's 27.23 B bf16 parameters (54.5 GB) fit an 80 GB card;
    mixtral-8x22b's (281 GB) fit none, which its docstring says."""
    assert torch_configs.get("gemma2-27b").n_params == 27_226_699_776
    mixtral = torch_configs.get("mixtral-8x22b")
    assert round(2 * mixtral.n_params / 1e9) == 281
    mod = torch_configs._module("mixtral-8x22b")
    assert "281 GB" in mod.__doc__ and "smoke config only" in mod.__doc__


@pytest.mark.parametrize("field,value", [
    ("norm", "batchnorm"), ("mlp_kind", "moe"), ("kv_cache_dtype", "fp8"),
    ("attn_impl", "pallas"), ("layer_pattern", ("local", "sliding"))])
def test_config_rejects_unknown_choices(field, value):
    with pytest.raises(ValueError, match=field):
        dataclasses.replace(torch_configs.get_smoke("gemma2-27b"),
                            **{field: value})


def test_layer_slots_follow_split_layers():
    """Layer i's (group, index) is its place in the reference's
    `_split_layers` stacks (np.nonzero of the local flags)."""
    for pattern in (("local", "global"), ("global", "local", "local"),
                    ("local",), ("global",)):
        cfg = dataclasses.replace(torch_configs.get_smoke("gemma2-27b"),
                                  n_layers=6, layer_pattern=pattern)
        jcfg = dataclasses.replace(jax_configs.get_smoke("gemma2-27b"),
                                   n_layers=6, layer_pattern=pattern)
        stacked = {"w": jnp.arange(6)}
        g, loc, _, _ = jax_transformer._split_layers(jcfg, stacked)
        groups = {"global": [] if g is None else list(np.asarray(g["w"])),
                  "local": [] if loc is None else list(np.asarray(loc["w"]))}
        for layer, (group, i) in enumerate(transformer.layer_slots(cfg)):
            assert groups[group][i] == layer


def test_init_params_makes_the_reference_tree():
    """The port's own init gives the reference's leaves and shapes (the
    layers unstacked) for every new config, biases and post-norms
    included."""
    for arch in ARCHS:
        tcfg = dataclasses.replace(torch_configs.get_smoke(arch),
                                   dtype=torch.float32)
        jcfg = dataclasses.replace(jax_configs.get_smoke(arch),
                                   dtype=jnp.float32)
        tp = transformer.init_params(tcfg, 0, "cpu")
        jp = jax_transformer.abstract_params(jcfg)
        shapes = jax.tree.map(lambda a: a.shape[1:], jp["layers"])
        for lp in tp["layers"]:
            assert jax.tree.map(lambda t: tuple(t.shape), lp) == shapes, arch
        assert set(tp) == set(jp)


# ---------------------------------------------------------------------------
# Components
# ---------------------------------------------------------------------------

def test_make_norm_dense_mlp_and_biased_attention_match_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    for kind in ("rmsnorm", "layernorm"):
        jinit, japply = jax_common.make_norm(kind)
        tinit, tapply = common.make_norm(kind)
        p = _drawn(functools.partial(jinit, 32, jnp.float32), rng)
        assert set(p) == set(tinit(32, torch.float32, "cpu"))
        ref = japply(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
        out = tapply({k: _t(v) for k, v in p.items()}, _t(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)
    with pytest.raises(ValueError, match="norm"):
        common.make_norm("batchnorm")

    for use_bias in (True, False):
        p = _drawn(functools.partial(jax_common.mlp_init,
                                     jax.random.PRNGKey(1), 32, 48,
                                     jnp.float32, use_bias), rng)
        ref = jax_common.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             "gelu_tanh")
        out = common.mlp({k: _t(v) for k, v in p.items()}, _t(x),
                         "gelu_tanh")
        _close(out, ref)
    p = _drawn(functools.partial(jax_common.gated_mlp_init,
                                 jax.random.PRNGKey(2), 32, 48, jnp.float32,
                                 True), rng)
    ref = jax_common.gated_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    _close(common.gated_mlp({k: _t(v) for k, v in p.items()}, _t(x)), ref)

    pos = np.broadcast_to(np.arange(5)[None], (2, 5)).astype(np.int32)
    for use_bias, qkv_only in ((True, False), (False, True)):
        kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                  use_bias=use_bias, qkv_bias_only=qkv_only)
        jspec, tspec = jax_common.AttnSpec(**kw), common.AttnSpec(**kw)
        p = _drawn(functools.partial(jax_common.attn_init,
                                     jax.random.PRNGKey(3), jspec,
                                     jnp.float32), rng)
        tp = {k: _t(v) for k, v in p.items()}
        assert set(tp) == set(common.attn_init(
            torch.Generator().manual_seed(0), tspec, torch.float32, "cpu"))
        assert ("bo" in tp) == (use_bias and not qkv_only)
        jp = jax.tree.map(jnp.asarray, p)
        ref = jax_common._project_qkv(jp, jspec, jnp.asarray(x),
                                      jnp.asarray(pos))
        out = common._project_qkv(tp, tspec, _t(x), _t(pos))
        for a, b in zip(out, ref):
            _close(a, b)
        ctx = rng.standard_normal((2, 5, 32)).astype(np.float32)
        _close(common.attn_out(tp, tspec, _t(ctx)),
               jax_common.attn_out(jp, jspec, jnp.asarray(ctx)))


def test_unembed_final_softcap_matches_jax():
    rng = np.random.default_rng(5)
    table = rng.standard_normal((64, 16)).astype(np.float32)
    x = 4.0 * rng.standard_normal((2, 3, 16)).astype(np.float32)
    ref = jax_common.unembed({"embedding": jnp.asarray(table)},
                             jnp.asarray(x), True, 30.0)
    out = common.unembed({"embedding": _t(table)}, _t(x), True, 30.0)
    _close(out, ref)
    assert float(out.abs().max()) < 30.0


def test_int8_codes_and_scales_equal_the_reference():
    """`_quantize_kv` gives the reference's codes and scales bit for bit,
    on random rows, on rows whose codes fall on .5 (round half to even),
    and on an all-zero row (the 1e-8 floor)."""
    rng = np.random.default_rng(6)
    rows = [rng.standard_normal((3, 7, 2, 16)).astype(np.float32),
            (3.0 * rng.standard_normal((3, 7, 2, 16))).astype(np.float32)]
    ties = np.zeros((1, 1, 2, 16), np.float32)
    ties[..., 0] = 127.0                        # scale exactly 1
    ties[..., 1:9] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -3.5]
    rows += [ties, np.zeros((1, 2, 2, 16), np.float32)]
    for x in rows:
        jc, js = jax_common._quantize_kv(jnp.asarray(x))
        tc, ts = common._quantize_kv(torch.from_numpy(x))
        assert tc.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        back = common._dequantize_kv(tc, ts, torch.float32)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jax_common._dequantize_kv(
                jc, js, jnp.float32)))
    assert list(common._quantize_kv(torch.from_numpy(ties))[0][0, 0, 0, 1:9]
                ) == [0, 2, 2, 0, -2, -2, 126, -4]


def test_frontend_stubs_draw_from_the_generator():
    stub = VisionStub(num_patches=8, d_model=64)
    a = stub.synth(torch.Generator().manual_seed(3), 2)
    b = stub.synth(torch.Generator().manual_seed(3), 2)
    assert a.shape == (2, 8, 64) and a.dtype == torch.bfloat16
    assert torch.equal(a, b) and 0.0 < float(a.float().std()) < 0.05
    audio = AudioStub(num_frames=4, d_model=16)
    assert audio.synth(torch.Generator().manual_seed(0), 3,
                       torch.float32).shape == audio.shape(3) == (3, 4, 16)
    assert torch_configs._module("phi-3-vision-4.2b").STUB.shape(1) == \
        (1, 576, 3072)


# ---------------------------------------------------------------------------
# Models against JAX
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_forward(arch):
    """The reference's tokens, logits and aux loss over 12 tokens."""
    _, jparams, (jforward, _, _) = _reference(arch)
    toks = np.random.default_rng(2).integers(1, 256, (2, 12)).astype(
        np.int32)
    jl, jaux = jforward(jparams, jnp.asarray(toks))
    return toks, np.asarray(jl), float(jaux)


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, attn_impl):
    """Full-sequence logits over 12 tokens (past gemma2's and mixtral's
    8-token window) and the MoE aux loss."""
    _, _, tb, tparams = _models(arch, attn_impl)
    toks, jl, jaux = _reference_forward(arch)
    tl, taux = tb.forward(tparams, _t(toks))
    _close(tl, jl)
    np.testing.assert_allclose(float(taux), jaux, rtol=0, atol=1e-6)


def _compare_caches(tcache, jcache, exact_codes):
    assert set(tcache) == set(jcache)
    for group in jcache:
        assert set(tcache[group]) == set(jcache[group])
        for name, ref in jcache[group].items():
            out = tcache[group][name]
            assert tuple(out.shape) == ref.shape, (group, name)
            if name in ("k", "v") and out.dtype == torch.int8:
                diff = np.abs(out.numpy().astype(np.int32)
                              - np.asarray(ref).astype(np.int32))
                assert diff.max() <= (0 if exact_codes else 1), (group, name)
            else:
                np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                           err_msg=f"{group}/{name}", **TOL)


CACHE_CASES = [(a, impl, "native") for a in ARCHS
               for impl in ("naive", "flash")] + [
    ("qwen2-1.5b", "naive", "int8"), ("qwen2-1.5b", "flash", "int8"),
    ("gemma2-27b", "flash", "int8")]


@functools.lru_cache(maxsize=None)
def _reference_decode(arch, kv):
    """The reference's ragged prefill and 10 greedy decode steps: the
    tokens it fed, its logits at every step and its final cache."""
    jb, jparams, (_, jprefill, jdecode) = _reference(arch, kv)
    toks, mask = _ragged_batch()
    dmask = np.ones((3, MAX_LEN), bool)
    dmask[:, :9] = mask
    jl, jcache = jprefill(jparams, jnp.asarray(toks),
                          jb.init_cache(3, MAX_LEN),
                          attn_mask=jnp.asarray(mask))
    fed, logits = [], [np.asarray(jl)]
    for i in range(10):
        fed.append(np.asarray(jnp.argmax(jl, axis=-1), np.int32))
        jl, jcache = jdecode(jparams, jnp.asarray(fed[-1]), jcache,
                             jnp.asarray(9 + i, jnp.int32),
                             attn_mask=jnp.asarray(dmask))
        logits.append(np.asarray(jl))
    return fed, logits, jax.tree.map(np.asarray, jcache)


@pytest.mark.parametrize("arch,attn_impl,kv", CACHE_CASES)
def test_prefill_and_decode_match_jax(arch, attn_impl, kv):
    """A ragged left-padded prefill of 9 tokens (it rolls gemma2's and
    mixtral's 8-slot rings) and 10 decode steps fed the same tokens (they
    wrap the rings): logits within 1e-4 at every step, and the cache
    groups leaf for leaf (int8 codes within one step of the reference's,
    the scales within 1e-4)."""
    _, _, tb, tparams = _models(arch, attn_impl, kv)
    fed, jlogits, jcache = _reference_decode(arch, kv)
    toks, mask = _ragged_batch()
    tl, tcache = tb.prefill(tparams, _t(toks), tb.init_cache(3, MAX_LEN,
                                                             "cpu"),
                            attn_mask=_t(mask))
    _close(tl, jlogits[0])
    dmask = np.ones((3, MAX_LEN), bool)
    dmask[:, :9] = mask
    for i, tok in enumerate(fed):
        tl, tcache = tb.decode_step(tparams, _t(tok), tcache, 9 + i,
                                    attn_mask=_t(dmask))
        _close(tl, jlogits[i + 1])
    _compare_caches(tcache, jcache, exact_codes=False)
    if tb.cfg.sliding_window:
        assert tcache["local"]["k"].shape[2] == tb.cfg.sliding_window


def test_int8_prefill_writes_the_reference_codes_for_the_same_keys():
    """Fed the same projected keys and values, the int8 prefill writes the
    reference's codes and scales bit for bit, plain and into a ring at an
    offset (the admission roll)."""
    rng = np.random.default_rng(8)
    spec_kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16)
    jspec, tspec = jax_common.AttnSpec(**spec_kw), common.AttnSpec(**spec_kw)

    @functools.partial(jax.jit, static_argnums=(3, 4))
    def reference(p, x, cache, ring, off):
        """The reference's int8 prefill, and its own projection of the
        same keys and values."""
        _, cache = jax_common.prefill_into_cache(p, jspec, x, cache,
                                                 ring=ring, pos_offset=off)
        pos = jnp.arange(x.shape[1])[None] + (off or 0)
        return cache, jax_common._project_qkv(p, jspec, x, pos)[1:]

    for ring, s, off in ((False, 6, None), (True, 5, 11), (True, 12, 3)):
        x = rng.standard_normal((2, s, 32)).astype(np.float32)
        p = _drawn(functools.partial(jax_common.attn_init,
                                     jax.random.PRNGKey(4), jspec,
                                     jnp.float32), rng)
        jcache, keys = reference(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x),
            jax_common.kv_cache_init(2, 8, 2, 16, jnp.int8), ring, off)
        tcache = common.kv_cache_init(2, 8, 2, 16, torch.int8, "cpu")
        common.prefill_into_cache({k: _t(v) for k, v in p.items()}, tspec,
                                  _t(x), tcache, ring=ring, pos_offset=off)
        # The same keys: the reference's own projection, quantized by both
        # (eagerly: compiled, XLA may round the reference's scale apart).
        for new in keys:
            jc, js = jax_common._quantize_kv(new)
            tc, ts = common._quantize_kv(_t(new))
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        for name in ("k", "v", "k_scale", "v_scale"):
            got, ref = tcache[name].numpy(), np.asarray(jcache[name])
            if name in ("k", "v"):
                assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_prefix_embeddings_match_jax(attn_impl):
    """phi-3-vision-smoke with 8 patch embeddings: `forward` (logits for
    the token positions only), and `prefill` at positions [0, 8 + S) then
    decode steps at 8 + S + i."""
    jb, jparams, tb, tparams = _models("phi-3-vision-4.2b", attn_impl)
    jforward, jprefill, jdecode = _reference("phi-3-vision-4.2b")[2]
    p = jb.cfg.num_prefix_embeddings
    rng = np.random.default_rng(9)
    prefix = (0.02 * rng.standard_normal((2, p, 64))).astype(np.float32)
    toks = rng.integers(1, 256, (2, 6)).astype(np.int32)
    jl, _ = jforward(jparams, jnp.asarray(toks),
                     prefix_embeddings=jnp.asarray(prefix))
    tl, _ = tb.forward(tparams, _t(toks), prefix_embeddings=_t(prefix))
    assert tuple(tl.shape) == (2, 6, 256)
    _close(tl, jl)
    plain, _ = tb.forward(tparams, _t(toks))
    assert not torch.allclose(plain, tl, atol=1e-3)

    jcache = jb.init_cache(2, MAX_LEN)
    tcache = tb.init_cache(2, MAX_LEN, "cpu")
    jl, jcache = jprefill(jparams, jnp.asarray(toks), jcache,
                          prefix_embeddings=jnp.asarray(prefix))
    tl, tcache = tb.prefill(tparams, _t(toks), tcache,
                            prefix_embeddings=_t(prefix))
    _close(tl, jl)
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        jl, jcache = jdecode(jparams, jnp.asarray(tok), jcache,
                             jnp.asarray(p + 6 + i, jnp.int32))
        tl, tcache = tb.decode_step(tparams, _t(tok), tcache, p + 6 + i)
        _close(tl, jl)


def test_prefix_embeddings_with_a_pad_mask():
    """A prefix before left-padded prompts, the prefix slots always valid:
    the naive path matches the reference's naive output, and the kernels'
    path (attn_impl="flash", a row's valid keys [0, P) and [P + pads, S)
    through the plain version's `prefix_len`) the reference's flash output
    (models/flash.py with the prefix-extended `kv_valid`), at 1e-4 in
    fp32."""
    jb, jparams, tb, tparams = _models("phi-3-vision-4.2b", "naive")
    p = jb.cfg.num_prefix_embeddings
    prefix = (0.02 * np.random.default_rng(10).standard_normal(
        (3, p, 64))).astype(np.float32)
    toks, mask = _ragged_batch()
    assert not mask.all(axis=1).all()          # some rows have pads
    jl, _ = _reference("phi-3-vision-4.2b")[2][1](jparams, jnp.asarray(toks),
                           jb.init_cache(3, MAX_LEN),
                           prefix_embeddings=jnp.asarray(prefix),
                           attn_mask=jnp.asarray(mask))
    tl, _ = tb.prefill(tparams, _t(toks), tb.init_cache(3, MAX_LEN, "cpu"),
                       prefix_embeddings=_t(prefix), attn_mask=_t(mask))
    _close(tl, jl)
    jflash = jax_bundle_for(dataclasses.replace(jb.cfg, attn_impl="flash"))
    jfl, _ = jax.jit(jflash.prefill)(jparams, jnp.asarray(toks),
                                     jflash.init_cache(3, MAX_LEN),
                                     prefix_embeddings=jnp.asarray(prefix),
                                     attn_mask=jnp.asarray(mask))
    flash_b = bundle_for(dataclasses.replace(tb.cfg, attn_impl="flash"))
    tfl, _ = flash_b.prefill(tparams, _t(toks),
                             flash_b.init_cache(3, MAX_LEN, "cpu"),
                             prefix_embeddings=_t(prefix), attn_mask=_t(mask))
    _close(tfl, jfl)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

ENGINE_CASES = [(a, "native") for a in ARCHS] + [("qwen2-1.5b", "int8"),
                                                  ("gemma2-27b", "int8")]


@pytest.mark.parametrize("arch,kv", ENGINE_CASES)
def test_greedy_tokens_match_jax_engine(arch, kv):
    """Same fp32 weights, same ragged prompts, attention through the
    kernels' plain versions: the port's engine (fused decode) gives the JAX
    engine's greedy tokens, and its eager loop the same."""
    jb, jparams, tb, tparams = _models(arch, "flash", kv)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, size=n).astype(np.int32)
               for n in (5, 9, 7, 12, 1)]
    # The reference's eager loop (its tests hold its fused path to it bit
    # for bit) compiles the quicker.
    ref, _ = JaxEngine(jb, jparams, max_batch=8, max_seq_len=48,
                       prompt_bucket=8, decode_impl="loop").generate(prompts,
                                                                     10)
    for impl in ("fused", "loop"):
        out, _ = InferenceEngine(tb, tparams, max_batch=8, max_seq_len=48,
                                 prompt_bucket=8, decode_impl=impl,
                                 device="cpu").generate(prompts, 10)
        np.testing.assert_array_equal(out, ref, err_msg=impl)


#: (prompt length, budget, arrival) of tests/test_torch_continuous.py's
#: staggered workload; at a prompt bucket of 4 the 3- and 5-token prompts
#: are shorter than the gemma2 smoke's 8-slot ring, so their admission
#: rolls the ring into place.
STAGGERED = ((5, 12, 0.0), (9, 4, 0.0), (13, 6, 0.5), (3, 5, 2.5),
             (20, 3, 3.0))


@pytest.mark.parametrize("arch,kv", [("gemma2-27b", "native"),
                                     ("qwen2-1.5b", "int8"),
                                     ("gemma2-27b", "int8")])
def test_continuous_matches_static_and_the_jax_engine(arch, kv):
    """Continuous batching over the two cache groups and the int8 leaves:
    every request at t=0 gives `generate`'s tokens; the staggered workload
    (admissions mid-decode, an EOS) gives the JAX engine's streams, steps
    and records."""
    jb, jparams, tb, tparams = _models(arch, "flash", kv)
    rng = np.random.default_rng(3)
    eng = InferenceEngine(tb, tparams, max_batch=4, max_seq_len=64,
                          prompt_bucket=4, device="cpu")
    prompts = [rng.integers(1, 256, size=n).astype(np.int32)
               for n, _, _ in STAGGERED]
    static, _ = eng.generate(prompts[:3], 8)
    streams, st = eng.generate_continuous(
        [EngineRequest(rid=i, prompt=p, max_new_tokens=8)
         for i, p in enumerate(prompts[:3])], n_slots=3, chunk=3)
    assert (st.decode_steps, st.prefill_calls) == (8, 1)
    for i in range(3):
        np.testing.assert_array_equal(streams[i], static[i])

    def staggered(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=m, arrival_s=a)
                for i, (p, (_, m, a)) in enumerate(zip(prompts, STAGGERED))]
    free, _ = eng.generate_continuous(staggered(EngineRequest), n_slots=2,
                                      chunk=4, step_time_s=1.0)
    kw = dict(n_slots=2, chunk=4, step_time_s=1.0, eos_id=int(free[0][2]))
    out, st = eng.generate_continuous(staggered(EngineRequest), **kw)
    ref, ref_st = JaxEngine(jb, jparams, max_batch=4, max_seq_len=64,
                            prompt_bucket=4).generate_continuous(
        staggered(JaxRequest), **kw)
    assert out.keys() == ref.keys()
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid], err_msg=str(rid))
    assert [(r.rid, r.slot, r.admit_s, r.finish_s, r.tokens)
            for r in st.records] == \
        [(r.rid, r.slot, r.admit_s, r.finish_s, r.tokens)
         for r in ref_st.records]
    assert any(r.admit_s > 0 for r in st.records)
