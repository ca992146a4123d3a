"""The port's inference engine and engine environment, on the CPU:
fused vs loop decode, greedy tokens against the JAX engine on shared
weights, ragged vs unpadded logits, prompt bucketing, input validation,
the in-place cache pool, the environment's observations, and the CUDA
default of the entry points."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
import repro_torch.configs as torch_configs
from repro.models.registry import bundle_for as jax_bundle_for
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.models.registry import bundle_for
from repro_torch.models.transformer import params_from_jax
from repro_torch.platform import make_env, make_space
from repro_torch.serving import energy
from repro_torch.serving.engine import EngineEnvironment, InferenceEngine

ARCH = "llama3.2-1b"


def _bundle(dtype=torch.float32, attn_impl="naive", seed=0):
    """Port bundle + params carried over from a JAX-initialised model, and
    the JAX bundle + params themselves (fp32 unless `dtype` says bf16)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = dataclasses.replace(jax_configs.get_smoke(ARCH), dtype=jdt,
                               attn_impl=attn_impl)
    tcfg = dataclasses.replace(torch_configs.get_smoke(ARCH), dtype=dtype,
                               attn_impl=attn_impl)
    jb = jax_bundle_for(jcfg)
    jparams = jb.init_params(jax.random.PRNGKey(seed))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams),
                              device="cpu")
    return bundle_for(tcfg), tparams, jb, jparams


def _engine(bundle, params, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("max_seq_len", 48)
    return InferenceEngine(bundle, params, device="cpu", **kw)


def _prompts(lengths, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32)
            for n in lengths]


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_fused_bit_identical_to_loop(attn_impl):
    tb, tp, _, _ = _bundle(torch.bfloat16, attn_impl)
    prompts = _prompts([5, 9, 7])
    out_f, st_f = _engine(tb, tp, decode_impl="fused").generate(prompts, 8)
    out_l, st_l = _engine(tb, tp, decode_impl="loop").generate(prompts, 8)
    np.testing.assert_array_equal(out_f, out_l)
    assert out_f.shape == (3, 8) and out_f.dtype == np.int32
    assert st_f.decode_impl == "fused" and st_l.decode_impl == "loop"


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_greedy_tokens_match_jax_engine(attn_impl):
    """Same fp32 weights, same ragged prompts: the port's greedy tokens
    equal the JAX engine's."""
    tb, tp, jb, jp = _bundle(torch.float32, attn_impl)
    prompts = _prompts([5, 9, 7, 16, 1], seed=1)
    ref, _ = JaxEngine(jb, jp, max_batch=8, max_seq_len=48).generate(
        prompts, 10)
    out, _ = _engine(tb, tp).generate(prompts, 10)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_ragged_batch_matches_unpadded_logits(attn_impl):
    tb, tp, _, _ = _bundle(torch.float32, attn_impl)
    rng = np.random.default_rng(1)
    p_short = rng.integers(1, 256, 5)
    p_long = rng.integers(1, 256, 9)
    toks = np.zeros((2, 9), np.int64)
    mask = np.zeros((2, 9), bool)
    toks[0, 4:], mask[0, 4:] = p_short, True
    toks[1], mask[1] = p_long, True
    cache = tb.init_cache(2, 32, "cpu")
    ragged, cache = tb.prefill(tp, torch.from_numpy(toks), cache,
                               attn_mask=torch.from_numpy(mask))
    solo_cache = tb.init_cache(1, 32, "cpu")
    solo, solo_cache = tb.prefill(tp, torch.from_numpy(p_short[None]),
                                  solo_cache)
    torch.testing.assert_close(ragged[0], solo[0], rtol=1e-5, atol=1e-5)
    nxt = torch.argmax(solo[0]).reshape(1)
    dmask = torch.ones((2, 32), dtype=torch.bool)
    dmask[:, :9] = torch.from_numpy(mask)
    lr, _ = tb.decode_step(tp, torch.cat([nxt, nxt]), cache, 9,
                           attn_mask=dmask)
    ls, _ = tb.decode_step(tp, nxt, solo_cache, 5)
    torch.testing.assert_close(lr[0], ls[0], rtol=1e-5, atol=1e-5)


def test_prompt_bucketing_preserves_tokens():
    tb, tp, _, _ = _bundle(torch.float32)
    prompts = _prompts([5, 9], seed=2)
    out1, _ = _engine(tb, tp, prompt_bucket=1).generate(prompts, 6)
    out16, _ = _engine(tb, tp, prompt_bucket=16).generate(prompts, 6)
    np.testing.assert_array_equal(out1, out16)


def test_generate_validation_errors():
    tb, tp, _, _ = _bundle()
    eng = _engine(tb, tp, max_batch=2, max_seq_len=48)
    good = _prompts([4])
    with pytest.raises(ValueError, match="at least one prompt"):
        eng.generate([], max_new_tokens=4)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate([np.zeros(0, np.int32)], max_new_tokens=4)
    with pytest.raises(ValueError, match="exceeds max_batch"):
        eng.generate(_prompts([4, 4, 4]), max_new_tokens=4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.generate(good, max_new_tokens=0)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate(good, max_new_tokens=40)   # bucketed 16 + 40 > 48
    with pytest.raises(ValueError, match="decode_impl"):
        _engine(tb, tp, decode_impl="eager")
    with pytest.raises(ValueError, match="prompt_bucket"):
        _engine(tb, tp, prompt_bucket=0)


@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
def test_pooled_cache_reuse_equals_fresh_engine(attn_impl):
    """K/V are written into the pooled cache in place, so a second call
    finds the first call's entries there; its tokens must still equal a
    fresh engine's (every read slot is rewritten or masked)."""
    tb, tp, _, _ = _bundle(torch.float32, attn_impl)
    eng = _engine(tb, tp, prompt_bucket=4)
    first = _prompts([15, 11, 13], seed=3)
    second = _prompts([3, 6, 2], seed=4)
    eng.generate(first, 12)
    reused, _ = eng.generate(second, 9)
    fresh, _ = _engine(tb, tp, prompt_bucket=4).generate(second, 9)
    np.testing.assert_array_equal(reused, fresh)
    assert eng.compile_counts["cache_pool"] == 1


def test_compile_counts_stay_flat_across_repeated_shapes():
    tb, tp, _, _ = _bundle()
    eng = _engine(tb, tp)
    for seed in range(3):
        eng.generate(_prompts([5, 7], seed=seed), 4)
    assert eng.compile_counts == {"prefill": 1, "decode_loop": 0,
                                  "decode_fused": 1, "cache_pool": 1}
    assert eng.calls["prefill", 2, 16] == 3
    eng.generate(_prompts([20], seed=9), 4)
    assert eng.compile_counts["prefill"] == 2
    assert eng.compile_counts["cache_pool"] == 2


def test_engine_environment_pull_observes_energy_and_latency():
    tb, tp, _, _ = _bundle(torch.bfloat16)
    env = EngineEnvironment(_engine(tb, tp, max_batch=8),
                            energy.JETSON_AGX_ORIN,
                            energy.ORIN_WORKLOADS["llama3.2-1b"],
                            prompt_len=6, max_new_tokens=3)
    obs = env.pull({"freq_mhz": 612.0, "batch": 4}, 0)
    assert obs.energy > 0 and obs.latency > 0 and obs.batch == 4
    assert obs.tokens == 12
    assert obs.metadata["decode_impl"] == "fused"
    assert obs.metadata["prefill_s"] > 0 and obs.metadata["decode_s"] > 0


def test_make_env_builds_the_engine_backend_on_request():
    env = make_env("engine/llama3.2-1b", device="cpu", max_batch=4,
                   max_seq_len=32, prompt_len=4, max_new_tokens=2)
    space = make_space("engine/llama3.2-1b")
    assert space.n_arms == 49
    obs = env.pull(space.values(space.corner(batch="min")), 0)
    assert obs.batch == 4 and obs.tokens == 8
    with pytest.raises(KeyError, match="unknown engine model"):
        make_env("engine/not-a-model", device="cpu")


def test_entry_points_default_to_cuda():
    """Without a device argument the entry points run on CUDA, and raise
    where there is none; the CPU runs only when asked for."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default is then usable")
    tb, tp, _, _ = _bundle()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(tb, tp, max_batch=2, max_seq_len=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_env("engine/llama3.2-1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tb.init_params(0)


@pytest.mark.parametrize("arch", sorted(torch_configs.ALIASES))
def test_make_env_builds_every_port_arch(arch):
    """`engine/<arch>` is offered and built from the arch's smoke config for
    every config of the port (olmoe-1b-7b included), as the reference's
    `_engine_live` does."""
    from repro_torch.platform.registry import available_envs
    assert f"engine/{arch}/live" in available_envs()
    env = make_env(f"engine/{arch}", device="cpu", max_batch=4,
                   max_seq_len=32, prompt_len=4, max_new_tokens=2)
    assert env.engine.bundle.cfg == torch_configs.get_smoke(arch)
    assert env.work is energy.ORIN_WORKLOADS["llama3.2-1b"]
    obs = env.pull({"freq_mhz": 612.0, "batch": 4}, 0)
    assert obs.batch == 4 and obs.tokens == 8 and obs.latency > 0
