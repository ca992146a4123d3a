"""The port's RecurrentGemma path (recurrentgemma-9b) against the JAX
package's, on the CPU.

- RG-LRU: `ops.rglru` (its plain version on a CPU tensor) and the port's
  sequential oracle against the JAX oracle and the Pallas kernel in
  interpret mode from a zero state, over the sweep of tests/test_kernels.py
  (rtol/atol 1e-4, as there); the model's `rglru_scan` (prompt and
  one-token step) against `repro.models.rglru`'s `rglru_scan` /
  `rglru_step` from a nonzero state (fp32, 1e-5); `ops.rglru_gated` (its
  plain version: `rglru_gates_ref`, then the step or the associative
  scan) from the pre-activations of JAX's own gate products, in fp32 and
  bf16, against the same (1e-5).
- The causal conv with a nonzero tail; the GeGLU MLP (tanh GeLU, which the
  exact form would fail); the sqrt(d) embedding scale.
- The ring KV cache: `cached_attention(ring=True)` over steps that wrap
  the ring, and `prefill_into_cache(ring=True)` for a prompt longer than
  the window (at offset 0 and at an offset) and a short prompt at an
  offset, with a pad mask, against `repro.models.common` in fp32 (1e-5).
- recurrentgemma-smoke in fp32 with JAX's weights (`params_from_jax`; the
  biases, conv bias and norm scales, zero at init, filled with seeded
  noise): forward logits, a left-padded prefill longer than the window and
  decode steps that wrap the ring, within 1e-4, for attn_impl naive and
  flash; the cache after it; decode from a JAX cache (`cache_from_jax`).
- decode == forward inside the port; the engine's greedy tokens equal the
  JAX engine's; fused == loop; a reused pooled cache equals a fresh one;
  `serve.py`'s engine mode on recurrentgemma-9b.

Ragged == unpadded is not asserted: the reference folds left pads into the
recurrent state.  tests/test_torch_cuda.py holds the CUDA kernel to the
plain versions on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro_torch.configs as torch_configs
from repro.kernels.rglru.ops import rglru as pallas_rglru
from repro.kernels.rglru.ref import rglru_scan_ref as jax_rglru_scan_ref
from repro.models import common as jax_common
from repro.models import rglru as jax_rglru
from repro.models.registry import bundle_for as jax_bundle_for
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.kernels.rglru import ops as rg_ops
from repro_torch.launch.serve import engine_mode
from repro_torch.models import common, rglru
from repro_torch.models.registry import bundle_for
from repro_torch.serving.engine import InferenceEngine

ARCH = "recurrentgemma-9b"
KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
EXACT_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 48


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


# --- the RG-LRU scan ----------------------------------------------------------

def _scan_inputs(b, s, w, seed, h0_scale=0.0):
    """The recipe of tests/test_kernels.py's RG-LRU sweep, from numpy."""
    rng = np.random.default_rng(seed)
    log_a = -np.exp(rng.standard_normal((b, s, w)) - 1.5)
    bb = rng.standard_normal((b, s, w))
    h0 = h0_scale * rng.standard_normal((b, w))
    return [np.asarray(a, np.float32) for a in (log_a, bb, h0)]


@pytest.mark.parametrize("b,s,w,chunk", [(1, 32, 128, 8), (2, 64, 256, 16),
                                         (2, 32, 256, 8), (1, 64, 128, 16)])
def test_rglru_plain_matches_oracle_and_pallas(b, s, w, chunk):
    log_a, bb, h0 = _scan_inputs(b, s, w, seed=s + w)
    jh, jlast = jax_rglru_scan_ref(jnp.asarray(log_a), jnp.asarray(bb))
    ph, plast = pallas_rglru(jnp.asarray(log_a), jnp.asarray(bb),
                             chunk=chunk, block_w=128, interpret=True)
    state = _t(h0)
    before = rg_ops.launches
    h, out = rg_ops.rglru(_t(log_a), _t(bb), state)
    assert out is state and rg_ops.launches == before
    assert h.dtype == torch.float32 and h.shape == (b, s, w)
    sh, slast = rg_ops.rglru_scan_ref(_t(log_a), _t(bb))
    for ref_h, ref_last in ((jh, jlast), (ph, plast)):
        for port_h, port_last in ((h, state), (sh, slast)):
            _close(port_h, ref_h, KERNEL_TOL)
            _close(port_last, ref_last, KERNEL_TOL)


@pytest.mark.parametrize("s", [1, 16])
def test_rglru_scan_and_step_honour_the_initial_state(s):
    """The model's scan (S > 1) and step (S == 1) against the reference
    model's associative scan and one-token step from a nonzero h0, with
    the gates computed from the same weights; the port's sequential and
    associative plain forms agree too."""
    rng = np.random.default_rng(s)
    w = 32
    bp = {"w_a": 0.2 * rng.standard_normal((w, w)),
          "w_i": 0.2 * rng.standard_normal((w, w)),
          "b_a": rng.standard_normal(w), "b_i": rng.standard_normal(w),
          "lru_lambda": np.log(np.expm1(-np.log(rng.uniform(0.9, 0.999, w))
                                        / 8.0))}
    bp = {k: np.asarray(v, np.float32) for k, v in bp.items()}
    y = rng.standard_normal((2, s, w)).astype(np.float32)
    h0 = rng.standard_normal((2, w)).astype(np.float32)
    jfn = jax_rglru.rglru_scan if s > 1 else jax_rglru.rglru_step
    jh, jlast = jfn({k: jnp.asarray(v) for k, v in bp.items()},
                    jnp.asarray(y), jnp.asarray(h0))
    state = _t(h0)
    h, out = rglru.rglru_scan({k: _t(v) for k, v in bp.items()}, _t(y), state)
    assert out is state
    _close(h, jh, EXACT_TOL)
    _close(state, jlast, EXACT_TOL)
    log_a, gated = rglru._rglru_gates({k: _t(v) for k, v in bp.items()},
                                      _t(y))
    jlog_a, jgated = jax_rglru._rglru_gates(
        {k: jnp.asarray(v) for k, v in bp.items()}, jnp.asarray(y))
    _close(log_a, jlog_a, EXACT_TOL)
    _close(gated, jgated, EXACT_TOL)
    for form in (rg_ops.rglru_scan_ref, rg_ops.rglru_assoc_ref):
        fh, flast = form(log_a, gated, _t(h0))
        _close(fh, jh, EXACT_TOL)
        _close(flast, jlast, EXACT_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 16, 37])
def test_rglru_gated_matches_jax_gates_and_scan(s, dtype):
    """The gated entry's CPU path against the reference's `_rglru_gates`
    followed by `rglru_step` (S 1) or `rglru_scan` from a nonzero state.
    The pre-activations are JAX's own products of the shared inputs, so
    the two sides start from the same za and zi; a few channels' lambda
    lie past softplus's threshold of 20."""
    rng = np.random.default_rng(100 + s)
    b, w = 2, 40
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    lam = np.log(np.expm1(-np.log(rng.uniform(0.9, 0.999, w)) / 8.0))
    lam[::13] = 25.0
    bp = {"w_a": 0.2 * rng.standard_normal((w, w)),
          "w_i": 0.2 * rng.standard_normal((w, w)),
          "b_a": rng.standard_normal(w), "b_i": rng.standard_normal(w),
          "lru_lambda": lam}
    jbp = {k: jnp.asarray(v, jdt if k in ("w_a", "w_i") else jnp.float32)
           for k, v in bp.items()}
    y = jnp.asarray(rng.standard_normal((b, s, w)), jdt)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    jfn = jax_rglru.rglru_scan if s > 1 else jax_rglru.rglru_step
    jh, jlast = jfn(jbp, y, jnp.asarray(h0))
    za, zi = (jnp.einsum("bsw,wu->bsu", y, jbp[k]) for k in ("w_a", "w_i"))
    port = [_t(np.asarray(a, np.float32)).to(tdt) for a in (za, zi, y)]
    state = _t(h0)
    before = rg_ops.launches
    h, out = rg_ops.rglru_gated(*port, _t(bp["b_a"]), _t(bp["b_i"]),
                                _t(lam), state)
    assert out is state and rg_ops.launches == before
    assert h.dtype == torch.float32 and h.shape == (b, s, w)
    _close(h, jh, EXACT_TOL)
    _close(state, jlast, EXACT_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_with_a_tail_matches_jax(dtype):
    rng = np.random.default_rng(1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y = rng.standard_normal((2, 5, 16)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 16)).astype(np.float32)
    bp = {"conv_w": 0.3 * rng.standard_normal((4, 16)).astype(np.float32),
          "conv_b": 0.1 * rng.standard_normal(16).astype(np.float32)}
    jout, jtail = jax_rglru._causal_conv(
        {k: jnp.asarray(v, jdt) for k, v in bp.items()},
        jnp.asarray(y, jdt), jnp.asarray(tail, jdt))
    out, new_tail = rglru._causal_conv(
        {k: _t(v).to(tdt) for k, v in bp.items()}, _t(y).to(tdt),
        _t(tail).to(tdt))
    assert out.dtype == tdt
    # bf16: the same roundings in the same order, so equal bits.
    tol = EXACT_TOL if dtype == "float32" else dict(rtol=0, atol=0)
    _close(out, np.asarray(jout, np.float32), tol)
    _close(new_tail, np.asarray(jtail, np.float32), tol)


def test_geglu_uses_the_tanh_gelu():
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(shape).astype(np.float32)
         for k, shape in (("w_gate", (16, 32)), ("w_up", (16, 32)),
                          ("w_down", (32, 16)))}
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    ref = jax_common.gated_mlp({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), act="gelu_tanh")
    tp = {k: _t(v) for k, v in p.items()}
    _close(common.gated_mlp(tp, _t(x), act="gelu_tanh"), ref, EXACT_TOL)
    exact = (torch.nn.functional.gelu(_t(x) @ tp["w_gate"])
             * (_t(x) @ tp["w_up"])) @ tp["w_down"]
    with pytest.raises(AssertionError):
        _close(exact, ref, EXACT_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_matches_jax(dtype):
    """sqrt(64) is exact; sqrt(48) rounds in bf16 before the product."""
    rng = np.random.default_rng(3)
    toks = np.array([[1, 5, 7], [0, 2, 2]], np.int32)
    for d in (64, 48):
        table = rng.standard_normal((8, d)).astype(np.float32)
        ref = jax_common.embed(
            {"embedding": jnp.asarray(table, getattr(jnp, dtype))},
            jnp.asarray(toks), scale_by_sqrt_dim=True)
        out = common.embed({"embedding": _t(table).to(getattr(torch, dtype))},
                           torch.from_numpy(toks).long(),
                           scale_by_sqrt_dim=True)
        assert out.dtype == getattr(torch, dtype)
        _close(out, np.asarray(ref, np.float32), dict(rtol=0, atol=0))


# --- the ring KV cache --------------------------------------------------------

WINDOW = 8


def _attn(attn_impl="naive", seed=4):
    rng = np.random.default_rng(seed)
    d, h, kvh, hd = 32, 4, 1, 16
    p = {"wq": rng.standard_normal((d, h * hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, kvh * hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, kvh * hd)) / np.sqrt(d),
         "wo": rng.standard_normal((h * hd, d)) / np.sqrt(h * hd)}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    kw = dict(d_model=d, n_heads=h, n_kv_heads=kvh, head_dim=hd,
              sliding_window=WINDOW, attn_impl=attn_impl)
    return (p, jax_common.AttnSpec(**kw), common.AttnSpec(**kw),
            {k: jnp.asarray(v) for k, v in p.items()},
            {k: _t(v) for k, v in p.items()})


def _pad_mask(b, plen, pads):
    m = np.ones((b, plen), bool)
    for i, n in enumerate(pads):
        m[i, :n] = False
    return m


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_ring_cached_attention_matches_jax(attn_impl):
    """Decode steps from a pad-masked ring, across two wraps: the new K/V
    go to slot pos % window and the mask follows the ring's positions
    (the kernel route is off for ring layers, as in the reference)."""
    p, jspec, tspec, jp, tp = _attn(attn_impl)
    rng = np.random.default_rng(5)
    b = 3
    pad = _pad_mask(b, 24, [0, 2, 5])
    kc = rng.standard_normal((2, b, WINDOW, 1, 16)).astype(np.float32)
    jc = {"k": jnp.asarray(kc[0]), "v": jnp.asarray(kc[1])}
    tc = {"k": _t(kc[0]), "v": _t(kc[1])}
    for pos in (3, 6, 7, 8, 13, 16, 21):
        x = rng.standard_normal((b, 1, 32)).astype(np.float32)
        jo, jc = jax_common.cached_attention(
            jp, jspec, jnp.asarray(x), jc, jnp.asarray(pos, jnp.int32),
            ring=True, pad_mask=jnp.asarray(pad))
        to, out = common.cached_attention(tp, tspec, _t(x), tc, pos,
                                          ring=True,
                                          pad_mask=torch.from_numpy(pad))
        assert out is tc
        _close(to, jo, EXACT_TOL)
        _close(tc["k"], jc["k"], EXACT_TOL)
        _close(tc["v"], jc["v"], EXACT_TOL)


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
@pytest.mark.parametrize("s,offset", [(13, None), (8, None), (13, 5),
                                      (5, 11), (5, None)])
def test_ring_prefill_into_cache_matches_jax(attn_impl, s, offset):
    """A prompt of s >= window keeps its last `window` tokens rolled to
    slot g % window (at offset 0 and at an offset); a shorter one at an
    offset is written at 0 into a fresh row and rolled; left pads masked."""
    p, jspec, tspec, jp, tp = _attn(attn_impl, seed=6)
    rng = np.random.default_rng(7 + s)
    b = 3
    x = rng.standard_normal((b, s, 32)).astype(np.float32)
    pad = _pad_mask(b, s, [0, 1, 3])
    zeros = np.zeros((b, WINDOW, 1, 16), np.float32)
    jo, jc = jax_common.prefill_into_cache(
        jp, jspec, jnp.asarray(x), {"k": jnp.asarray(zeros),
                                    "v": jnp.asarray(zeros)},
        ring=True, pad_mask=jnp.asarray(pad),
        pos_offset=None if offset is None else jnp.asarray(offset,
                                                           jnp.int32))
    tc = {"k": _t(zeros), "v": _t(zeros)}
    to, _ = common.prefill_into_cache(tp, tspec, _t(x), tc, ring=True,
                                      pad_mask=torch.from_numpy(pad),
                                      pos_offset=offset)
    valid = pad[:, :, None]           # pad rows: 0 in flash, mean in naive
    _close(torch.from_numpy(np.where(valid, to.numpy(), 0)),
           np.where(valid, np.asarray(jo), 0), EXACT_TOL)
    _close(tc["k"], jc["k"], EXACT_TOL)
    _close(tc["v"], jc["v"], EXACT_TOL)


# --- the model ----------------------------------------------------------------

#: Leaves the reference initialises to zero, filled with seeded noise so
#: that the gate biases, the conv bias and the norm scales all count.
_NOISE = {"b_a": 0.5, "b_i": 0.5, "conv_b": 0.1, "scale": 0.1}


def _noisy(tree, rng, key=None):
    if isinstance(tree, dict):
        return {k: _noisy(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if key in _NOISE:
        a = a + _NOISE[key] * rng.standard_normal(a.shape).astype(np.float32)
    return jnp.asarray(a, tree.dtype)


def _models(dtype=torch.float32, attn_impl="naive", seed=0):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = dataclasses.replace(jax_configs.get_smoke(ARCH), dtype=jdt,
                               attn_impl=attn_impl)
    tcfg = dataclasses.replace(torch_configs.get_smoke(ARCH), dtype=dtype,
                               attn_impl=attn_impl)
    jb = jax_bundle_for(jcfg)
    jparams = _noisy(jb.init_params(jax.random.PRNGKey(seed)),
                     np.random.default_rng(seed))
    tparams = rglru.params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    return jb, jparams, bundle_for(tcfg), tparams


def _ragged(lengths, plen, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), plen), np.int32)
    mask = np.zeros((len(lengths), plen), bool)
    for i, n in enumerate(lengths):
        toks[i, plen - n:] = rng.integers(1, 256, n)
        mask[i, plen - n:] = True
    return toks, mask


def _close_cache(tcache, jcache):
    for key in ("conv_tail", "lru_h"):
        _close(tcache[key], jcache[key])
    for key in ("k", "v"):
        _close(tcache["attn"][key], jcache["attn"][key])


def test_config_matches_reference():
    for get in ("get", "get_smoke"):
        j = getattr(jax_configs, get)(ARCH)
        t = getattr(torch_configs, get)(ARCH)
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "width",
                  "sliding_window", "pattern", "block_types", "rope_theta",
                  "attn_impl", "tie_embeddings", "remat", "max_seq_len"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        assert t.n_params == j.n_params
        assert t.n_active_params == j.n_active_params
    assert torch_configs.get(ARCH).n_params == 9_396_559_872
    smoke = torch_configs.get_smoke(ARCH)
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(smoke, remat="full")
    with pytest.raises(ValueError, match="attn_impl"):
        dataclasses.replace(smoke, attn_impl="splash")


def test_params_from_jax_and_init_params_make_the_reference_tree():
    jb, jparams, tb, tparams = _models(dtype=torch.bfloat16)

    def shapes(node):
        return jax.tree.map(lambda a: tuple(a.shape), node,
                            is_leaf=lambda a: hasattr(a, "shape"))

    groups = {"rec_blocks": 2, "attn_blocks": 1, "mlps": 3}
    for params in (tparams, tb.init_params(0, "cpu")):
        assert set(params) == set(jparams)
        for key, n in groups.items():
            assert len(params[key]) == n
            ref = jax.tree.map(lambda s: s[1:], shapes(jparams[key]),
                               is_leaf=lambda x: isinstance(x, tuple))
            assert shapes(params[key][n - 1]) == ref
        for key in ("embedding", "norms_temporal", "norms_mlp",
                    "final_norm"):
            assert shapes(params[key]) == shapes(jparams[key])
        rec = params["rec_blocks"][1]
        assert {k for k, v in rec.items() if v.dtype == torch.float32} == {
            "lru_lambda", "b_a", "b_i"}
        assert rec["w_x"].dtype == torch.bfloat16
        a = torch.exp(-8.0 * torch.nn.functional.softplus(rec["lru_lambda"]))
        assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999
    np.testing.assert_array_equal(
        tparams["rec_blocks"][1]["b_a"].numpy(),
        np.asarray(jparams["rec_blocks"]["b_a"][1], np.float32))


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_forward_logits_match_jax(attn_impl):
    """13 tokens over a window of 8: the window bites."""
    jb, jparams, tb, tparams = _models(attn_impl=attn_impl)
    toks = np.random.default_rng(2).integers(1, 256, (3, 13)).astype(
        np.int32)
    jl, _ = jb.forward(jparams, jnp.asarray(toks))
    tl, aux = tb.forward(tparams, torch.from_numpy(toks).long())
    _close(tl, jl)
    assert float(aux) == 0.0


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_prefill_and_decode_wrap_the_ring_like_jax(attn_impl):
    """A ragged left-padded prompt of 12 into a ring of 8 (the prefill
    rolls), then 10 decode steps that wrap it; logits, the recurrent
    state and the ring agree with JAX's."""
    jb, jparams, tb, tparams = _models(attn_impl=attn_impl)
    plen = 12
    toks, mask = _ragged([12, 7, 3], plen, seed=0)
    jcache = jb.init_cache(3, MAX_LEN)
    tcache = tb.init_cache(3, MAX_LEN, "cpu")
    assert tuple(tcache["attn"]["k"].shape) == (1, 3, WINDOW, 1, 16)
    before = rg_ops.launches
    jl, jcache = jb.prefill(jparams, jnp.asarray(toks), jcache,
                            attn_mask=jnp.asarray(mask))
    tl, tcache = tb.prefill(tparams, torch.from_numpy(toks).long(), tcache,
                            attn_mask=torch.from_numpy(mask))
    _close(tl, jl)
    _close_cache(tcache, jcache)
    dmask = np.ones((3, MAX_LEN), bool)
    dmask[:, :plen] = mask
    for i in range(10):
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        jl, jcache = jb.decode_step(jparams, jnp.asarray(tok), jcache,
                                    jnp.asarray(plen + i, jnp.int32),
                                    attn_mask=jnp.asarray(dmask))
        tl, tcache = tb.decode_step(tparams, torch.from_numpy(tok.copy()),
                                    tcache, plen + i,
                                    attn_mask=torch.from_numpy(dmask))
        _close(tl, jl)
    _close_cache(tcache, jcache)
    assert rg_ops.launches == before


def test_cache_from_jax_continues_a_jax_prefill():
    jb, jparams, tb, tparams = _models()
    toks, _ = _ragged([9, 9], 9, seed=5)
    jl, jcache = jb.prefill(jparams, jnp.asarray(toks),
                            jb.init_cache(2, MAX_LEN))
    cache = rglru.cache_from_jax(tb.cfg, jax.tree.map(np.asarray, jcache),
                                 device="cpu")
    assert cache["lru_h"].dtype == torch.float32
    assert tuple(cache["conv_tail"].shape) == (2, 2, 3, 64)
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        jl, jcache = jb.decode_step(jparams, jnp.asarray(tok), jcache,
                                    jnp.asarray(9 + i, jnp.int32))
        tl, cache = tb.decode_step(tparams, torch.from_numpy(tok.copy()),
                                   cache, 9 + i)
        _close(tl, jl)


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_decode_matches_forward(attn_impl):
    """Inside the port, as tests/test_models_decode_equiv.py: prefill and
    step-by-step decode reproduce the teacher-forced forward logits, with
    the ring wrapping (7 + 9 positions over a window of 8)."""
    _, _, tb, tparams = _models(attn_impl=attn_impl)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, 256, (2, 16)).astype(np.int64))
    full, _ = tb.forward(tparams, toks)
    for prompt in (7, 10):
        cache = tb.init_cache(2, MAX_LEN, "cpu")
        logits, cache = tb.prefill(tparams, toks[:, :prompt], cache)
        torch.testing.assert_close(logits, full[:, prompt - 1], **TOL)
        for p in range(prompt, 16):
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


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_greedy_tokens_match_jax_engine(attn_impl):
    """Same fp32 weights, same ragged prompts, a ring of 8 slots under a
    48-slot engine (as tests/test_engine_fused.py): the port's engine
    gives the JAX engine's greedy token stream."""
    jb, jparams, tb, tparams = _models(attn_impl=attn_impl)
    for lengths, bucket in (([5, 9, 7, 16, 1], 16), ([20, 3], 4)):
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
    """The recurrent state and the ring are updated in place in the pooled
    cache; a second generate at the same batch must zero the state (and
    may leave the ring as it is) and give a fresh engine's tokens."""
    _, _, tb, tp = _models()
    eng = _engine(tb, tp, prompt_bucket=4)
    eng.generate(_prompts([15, 11, 13], seed=3), 12)
    pooled = eng._cache_pool[3]
    assert float(pooled["lru_h"].abs().sum()) > 0
    assert float(pooled["conv_tail"].abs().sum()) > 0
    second = _prompts([3, 6, 2], seed=4)
    reused, _ = eng.generate(second, 9)
    fresh, _ = _engine(tb, tp, prompt_bucket=4).generate(second, 9)
    np.testing.assert_array_equal(reused, fresh)
    assert eng.compile_counts["cache_pool"] == 1


def test_serve_engine_mode_runs_recurrentgemma():
    out = engine_mode(ARCH, rounds=2, alpha=0.5, seed=0, device="cpu")
    assert out["total_tokens"] > 0 and out["energy_per_req"] > 0
