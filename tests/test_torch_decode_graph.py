"""The fused decode's device-side position and its graph count, on the CPU.

- Every family's `decode_step` (llama3.2-1b, olmoe-1b-7b, rwkv6-3b and
  recurrentgemma-9b smoke configs in fp32, attn_impl naive and flash where
  the family has both) with `pos` as a 0-d tensor gives the same bits, in
  its logits and its cache, as with a Python int, and matches the JAX
  `decode_step` under `jax.jit` with a traced `pos` within 1e-4 (the
  tolerance of tests/test_models_decode_equiv.py).  The prompt is ragged
  (left pads) and recurrentgemma's 8-slot ring wraps during the steps.
- `compile_counts["decode_fused"]` equals the JAX engine's over the same
  generates: two prompt buckets at one batch (one entry: the position is
  on the device), then a second batch (two).
- The engine's CPU fused path holds one eager `DecodeGraph` a batch size,
  with no CUDA graph and no launches.

The card side (graph replay == eager loop, bit for bit; the sync gate; a
failed capture raises) is in tests/test_torch_cuda.py.
"""

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
from repro_torch.models import common
from repro_torch.models.registry import bundle_for
from repro_torch.serving.engine import InferenceEngine

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 48
STEPS = 4
#: (arch, attn_impl); rwkv6 has no attention.
CASES = [("llama3.2-1b", "naive"), ("llama3.2-1b", "flash"),
         ("olmoe-1b-7b", "naive"), ("olmoe-1b-7b", "flash"),
         ("rwkv6-3b", None),
         ("recurrentgemma-9b", "naive"), ("recurrentgemma-9b", "flash")]
#: Leaves that start at zero (norm scales, biases) or at a constant (the
#: rwkv6 mixes, decay and bonus, the RG-LRU gate biases), filled with
#: seeded noise so that they take part.
_NOISE_KEYS = {"scale", "bias", "b_a", "b_i", "conv_b", "maa_x",
               "maa_rkvwg", "maa_k", "maa_r", "decay_base", "bonus"}


def _noisy(tree, rng, key=None):
    if isinstance(tree, dict):
        return {k: _noisy(v, rng, k) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    if key in _NOISE_KEYS:
        a = a + 0.3 * rng.standard_normal(a.shape).astype(np.float32)
    return jnp.asarray(a, tree.dtype)


def _models(arch, attn_impl, seed=0):
    """JAX bundle + params and the port's bundle + the same params, fp32."""
    kw = {} if attn_impl is None else {"attn_impl": attn_impl}
    jcfg = dataclasses.replace(jax_configs.get_smoke(arch),
                               dtype=jnp.float32, **kw)
    tcfg = dataclasses.replace(torch_configs.get_smoke(arch),
                               dtype=torch.float32, **kw)
    jb, tb = jax_bundle_for(jcfg), bundle_for(tcfg)
    jparams = _noisy(jb.init_params(jax.random.PRNGKey(seed)),
                     np.random.default_rng(seed))
    tparams = tb.module.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jb, jparams, tb, tparams


def _ragged(lengths, plen, seed):
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lengths), plen), np.int32)
    mask = np.zeros((len(lengths), plen), bool)
    for i, n in enumerate(lengths):
        toks[i, plen - n:] = rng.integers(1, 256, n)
        mask[i, plen - n:] = True
    return toks, mask


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _assert_same_bits(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same_bits(a[k], b[k])
    else:
        assert torch.equal(a, b)


def test_as_pos_takes_an_int_or_a_tensor():
    p = common.as_pos(7, torch.device("cpu"))
    assert p.shape == () and p.dtype == torch.int64 and int(p) == 7
    t = torch.tensor(9, dtype=torch.int32)
    q = common.as_pos(t, torch.device("cpu"))
    assert q.dtype == torch.int64 and int(q) == 9
    same = torch.tensor(3)
    assert common.as_pos(same, torch.device("cpu")) is same


@pytest.mark.parametrize("arch,attn_impl", CASES)
def test_device_pos_step_matches_int_pos_and_jax_traced_pos(arch,
                                                            attn_impl):
    jb, jparams, tb, tparams = _models(arch, attn_impl)
    plen = 10
    toks, mask = _ragged([10, 6, 3], plen, seed=1)
    b = toks.shape[0]
    jl, jcache = jb.prefill(jparams, jnp.asarray(toks),
                            jb.init_cache(b, MAX_LEN),
                            attn_mask=jnp.asarray(mask))
    _, tcache = tb.prefill(tparams, torch.from_numpy(toks).long(),
                           tb.init_cache(b, MAX_LEN, "cpu"),
                           attn_mask=torch.from_numpy(mask))
    int_cache = _clone(tcache)
    dmask = np.ones((b, MAX_LEN), bool)
    dmask[:, :plen] = mask
    tmask = torch.from_numpy(dmask)
    jstep = jax.jit(lambda p, t, c, pos, m: jb.decode_step(
        p, t, c, pos, attn_mask=m))
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jl, axis=-1), np.int32)
        jl, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                           jnp.asarray(plen + i, jnp.int32),
                           jnp.asarray(dmask))
        ttok = torch.from_numpy(tok.copy()).long()
        il, int_cache = tb.decode_step(tparams, ttok, int_cache, plen + i,
                                       attn_mask=tmask)
        tl, tcache = tb.decode_step(tparams, ttok, tcache,
                                    torch.tensor(plen + i), attn_mask=tmask)
        assert torch.equal(tl, il)
        _assert_same_bits(tcache, int_cache)
        torch.testing.assert_close(
            tl, torch.from_numpy(np.array(jl, np.float32)), **TOL)


def test_decode_fused_count_matches_jax_engine():
    """Two prompt buckets at batch 2 share one fused decode (the position
    is on the device, as the reference's traced `start_pos`); batch 3 adds
    one.  The tokens agree with the JAX engine's on the way."""
    jb, jparams, tb, tparams = _models("llama3.2-1b", "naive")
    jeng = JaxEngine(jb, jparams, max_batch=4, max_seq_len=MAX_LEN)
    teng = InferenceEngine(tb, tparams, max_batch=4, max_seq_len=MAX_LEN,
                           device="cpu")
    rng = np.random.default_rng(2)
    calls = [[5, 9], [20, 3], [7, 7, 7]]         # buckets 16, 32, 16
    for i, lengths in enumerate(calls):
        prompts = [rng.integers(1, 256, n).astype(np.int32)
                   for n in lengths]
        ref, _ = jeng.generate(prompts, 6)
        out, _ = teng.generate(prompts, 6)
        np.testing.assert_array_equal(out, ref)
        assert teng.compile_counts["decode_fused"] == \
            jeng.compile_counts["decode_fused"] == (1 if i < 2 else 2)
    assert teng.compile_counts["prefill"] == 3
    assert teng.calls["decode_fused", 2, 16] == 1
    assert teng.calls["decode_fused", 2, 32] == 1


def test_cpu_fused_path_runs_the_step_eagerly():
    _, _, tb, tparams = _models("llama3.2-1b", "naive")
    eng = InferenceEngine(tb, tparams, max_batch=4, max_seq_len=MAX_LEN,
                          device="cpu")
    prompts = [np.arange(1, 6, dtype=np.int32)] * 3
    eng.generate(prompts, 4)
    eng.generate(prompts, 4)
    (graph,) = eng.decode_graphs.values()
    assert graph.graph is None and graph.replays == 0 and graph.tally == {}
    assert graph.tok.shape == (3,) and graph.mask.shape == (3, MAX_LEN)
    assert int(graph.pos) == 16 + 4             # bucket 16, 4 steps
    loop = InferenceEngine(tb, tparams, max_batch=4, max_seq_len=MAX_LEN,
                           decode_impl="loop", device="cpu")
    loop.generate(prompts, 4)
    assert loop.decode_graphs == {} and \
        loop.compile_counts["decode_fused"] == 0
