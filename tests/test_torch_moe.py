"""The port's MoE path (olmoe-1b-7b) against the JAX package's, on the CPU.

- The grouped GEMM: `grouped_gemm` (its plain version on a CPU tensor) and
  `moe_gemm_ref` against the JAX kernel in interpret mode, over the sweep of
  tests/test_kernels.py, at 1e-4.
- `moe_apply` in fp32 for S > 1 (per-row dispatch) and S == 1 (batch
  dispatch) at the reference capacity factor 1.25, on inputs that make
  some (token, k) pairs drop: outputs within 1e-5, aux loss within 1e-6.
- olmoe-smoke with JAX's weights (`params_from_jax`), fp32: forward logits
  and aux, prefill + decode logits, naive and flash, within 1e-4 (the
  reference's flash-vs-naive tolerance).
- The engine's greedy tokens equal the JAX engine's on a ragged,
  left-padded batch.

tests/test_torch_cuda.py holds the CUDA kernel to the plain version on the
card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro_torch.configs as torch_configs
from repro.kernels.moe_gemm.ops import grouped_gemm as jax_grouped_gemm
from repro.kernels.moe_gemm.ops import moe_gemm_ref as jax_moe_gemm_ref
from repro.models import moe as jax_moe
from repro.models.registry import bundle_for as jax_bundle_for
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.kernels.moe_gemm import ops as mg_ops
from repro_torch.models import moe
from repro_torch.models.registry import bundle_for
from repro_torch.models.transformer import params_from_jax
from repro_torch.serving.engine import InferenceEngine

ARCH = "olmoe-1b-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 32


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


# --- grouped GEMM -------------------------------------------------------------

# Every value of the reference's sweep (tests/test_kernels.py:205-212).
GEMM_SHAPES = [(2, 32, 32, 48), (2, 96, 64, 64), (4, 64, 32, 64),
               (4, 32, 64, 48), (8, 96, 32, 48), (8, 64, 64, 64)]


@pytest.mark.parametrize("e,c,d,f", GEMM_SHAPES)
def test_grouped_gemm_matches_pallas(e, c, d, f):
    rng = np.random.default_rng(e * 100 + c + d + f)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    ref = jax_grouped_gemm(jnp.asarray(x), jnp.asarray(w), interpret=True,
                           block_c=32, block_f=32, block_k=32)
    before = mg_ops.launches
    out = mg_ops.grouped_gemm(_t(x), _t(w))
    assert out.shape == (e, c, f) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(mg_ops.moe_gemm_ref(_t(x), _t(w)).numpy(),
                               np.asarray(jax_moe_gemm_ref(x, w)), **TOL)
    assert mg_ops.launches == before       # the CPU path launches nothing


def test_grouped_gemm_ref_keeps_bf16_and_accumulates_in_fp32():
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((2, 5, 64))).bfloat16()
    w = _t(rng.standard_normal((2, 64, 16)) / 8).bfloat16()
    out = mg_ops.grouped_gemm(x, w)
    assert out.dtype == torch.bfloat16
    exact = torch.einsum("ecd,edf->ecf", x.double(), w.double())
    assert torch.allclose(out.double(), exact, rtol=1e-2, atol=1e-2)


# --- moe_apply ----------------------------------------------------------------

MOE_CFG = dict(n_experts=8, top_k=2, d_ff=32)


def _moe_inputs(b, s, d=64, seed=0):
    """JAX MoE params (fp32) and their torch copy, plus inputs with a shared
    direction that skews the router toward a few experts, so some pairs
    overflow capacity 1.25."""
    jcfg = jax_moe.MoEConfig(**MOE_CFG)
    tcfg = moe.MoEConfig(**MOE_CFG)
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), d, jcfg, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, d)) + 1.5 * rng.standard_normal(d)
         ).astype(np.float32)
    return jcfg, jp, tcfg, tp, x


def _dropped_pairs(tp, tcfg, x):
    """(token, k) pairs past their expert's capacity, counted from the
    routing alone: per row for S > 1, over the batch for S == 1."""
    b, s, d = x.shape
    rows = x.reshape(1, b, d) if s == 1 else x
    cap = tcfg.capacity(rows.shape[1])
    probs = torch.softmax(_t(rows) @ tp["router"], dim=-1)
    topi = torch.topk(probs, tcfg.top_k, dim=-1).indices
    counts = torch.stack([torch.bincount(r.reshape(-1),
                                         minlength=tcfg.n_experts)
                          for r in topi])
    return int((counts - cap).clamp_min(0).sum())


@pytest.mark.parametrize("b,s", [(3, 12), (12, 1)],
                         ids=["per_row_S12", "batch_S1"])
def test_moe_apply_matches_jax_with_drops(b, s):
    jcfg, jp, tcfg, tp, x = _moe_inputs(b, s)
    assert _dropped_pairs(tp, tcfg, x) > 0
    # The routing itself: torch.topk picks JAX's experts on these inputs.
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x), jp["router"])
    jtop = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), tcfg.top_k)[1]
    ttop = torch.topk(torch.softmax(_t(x) @ tp["router"], -1), tcfg.top_k,
                      dim=-1, sorted=True).indices
    np.testing.assert_array_equal(ttop.numpy(), np.asarray(jtop))

    jout, jaux = jax_moe.moe_apply(jp, jcfg, jnp.asarray(x))
    out, aux = moe.moe_apply(tp, tcfg, _t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)


def test_dropped_pair_leaves_only_the_residual():
    """With capacity == top_k == 1 and one expert, only the first token of
    a row is served; the others get exactly 0 from the FFN."""
    tcfg = moe.MoEConfig(n_experts=1, top_k=1, d_ff=16, capacity_factor=0.1)
    gen = torch.Generator().manual_seed(0)
    tp = moe.moe_init(gen, 32, tcfg, torch.float32, "cpu")
    x = torch.randn((2, 5, 32), generator=gen)
    out, _ = moe.moe_apply(tp, tcfg, x)
    assert tcfg.capacity(5) == 1
    assert torch.all(out[:, 1:] == 0) and torch.all(out[:, 0] != 0)


# --- the model ------------------------------------------------------------------

def _models(attn_impl: str = "naive", dtype=torch.float32, seed=0):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = dataclasses.replace(jax_configs.get_smoke(ARCH), dtype=jdt,
                               attn_impl=attn_impl)
    tcfg = dataclasses.replace(torch_configs.get_smoke(ARCH), dtype=dtype,
                               attn_impl=attn_impl)
    jb = jax_bundle_for(jcfg)
    jparams = jb.init_params(jax.random.PRNGKey(seed))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return jb, jparams, bundle_for(tcfg), tparams


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_config_matches_reference():
    for get in ("get", "get_smoke"):
        j = getattr(jax_configs, get)(ARCH)
        t = getattr(torch_configs, get)(ARCH)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "rope_theta",
                  "tie_embeddings", "qk_norm", "attn_impl", "max_seq_len"):
            assert getattr(t, f) == getattr(j, f), (get, f)
        for f in ("n_experts", "top_k", "d_ff", "capacity_factor", "act",
                  "router_aux_coef"):
            assert getattr(t.moe, f) == getattr(j.moe, f), (get, f)
        assert t.n_params == j.n_params
        assert t.n_active_params == j.n_active_params
    assert torch_configs.get(ARCH).n_params == 6_919_094_272


def test_params_from_jax_keeps_leaves_and_router_dtype():
    """Every JAX leaf crosses (lm_head, q_norm/k_norm, the experts); the
    router stays fp32 when the config is bf16, as the reference makes it."""
    jb, jparams, tb, tparams = _models(dtype=torch.bfloat16)
    assert set(tparams) == set(jparams) == {"embedding", "layers",
                                            "final_norm", "lm_head"}
    lp = tparams["layers"][0]
    assert set(lp["attn"]) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    assert set(lp["moe"]) == {"router", "w_gate", "w_up", "w_down"}
    assert lp["moe"]["router"].dtype == torch.float32
    assert jparams["layers"]["moe"]["router"].dtype == jnp.float32
    assert lp["moe"]["w_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        lp["moe"]["router"].numpy(),
        np.asarray(jparams["layers"]["moe"]["router"][0]))
    np.testing.assert_array_equal(
        lp["moe"]["w_down"].float().numpy(),
        np.asarray(jparams["layers"]["moe"]["w_down"][0], np.float32))
    assert tuple(lp["moe"]["w_up"].shape) == (8, 64, 64)


def test_init_params_makes_the_reference_tree():
    jb, jparams, tb, _ = _models(dtype=torch.bfloat16)
    params = tb.init_params(0, "cpu")
    ref = jax.tree.map(lambda a: (a.shape[1:], a.dtype), jparams["layers"])
    got = jax.tree.map(lambda a: (tuple(a.shape), a.dtype),
                       params["layers"][0])
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    assert params["layers"][0]["moe"]["router"].dtype == torch.float32
    assert params["lm_head"].shape == params["embedding"].shape
    assert not torch.equal(params["lm_head"], params["embedding"])


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_forward_logits_and_aux_match_jax(attn_impl):
    jb, jparams, tb, tparams = _models(attn_impl)
    toks = np.random.default_rng(2).integers(1, 256, (3, 12)).astype(
        np.int32)
    jl, jaux = jb.forward(jparams, jnp.asarray(toks))
    tl, taux = tb.forward(tparams, torch.from_numpy(toks))
    _close(tl, jl)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-6)
    assert float(taux) > 0


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_prefill_and_decode_match_jax(attn_impl):
    """A ragged left-padded prefill (pads routed and taking capacity, as in
    the reference) and 4 decode steps fed the same tokens."""
    jb, jparams, tb, tparams = _models(attn_impl)
    rng = np.random.default_rng(0)
    toks = np.zeros((3, 9), np.int32)
    mask = np.zeros((3, 9), bool)
    for i, n in enumerate([9, 5, 1]):
        toks[i, 9 - n:] = rng.integers(1, 256, n)
        mask[i, 9 - n:] = True
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


def test_decode_matches_forward_at_ample_capacity():
    """Inside the port: with capacity_factor 8 (no drops either way, as
    tests/test_models_decode_equiv.py sets it) prefill + step-by-step
    decode reproduces the full-sequence forward logits."""
    _, _, tb, tparams = _models("flash")
    cfg = dataclasses.replace(tb.cfg, moe=dataclasses.replace(
        tb.cfg.moe, capacity_factor=8.0))
    tb = bundle_for(cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        1, 256, (2, 10)).astype(np.int64))
    full, _ = tb.forward(tparams, toks)
    cache = tb.init_cache(2, MAX_LEN, "cpu")
    logits, cache = tb.prefill(tparams, toks[:, :4], cache)
    torch.testing.assert_close(logits, full[:, 3], **TOL)
    for p in range(4, 10):
        logits, cache = tb.decode_step(tparams, toks[:, p], cache, p)
        torch.testing.assert_close(logits, full[:, p], **TOL)


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_greedy_tokens_match_jax_engine(attn_impl):
    """Same fp32 weights, same ragged prompts: the port's engine gives the
    JAX engine's greedy token stream."""
    jb, jparams, tb, tparams = _models(attn_impl)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 256, size=n).astype(np.int32)
               for n in (5, 9, 7, 16, 1)]
    ref, _ = JaxEngine(jb, jparams, max_batch=8, max_seq_len=48).generate(
        prompts, 10)
    out, _ = InferenceEngine(tb, tparams, max_batch=8, max_seq_len=48,
                             device="cpu").generate(prompts, 10)
    np.testing.assert_array_equal(out, ref)
