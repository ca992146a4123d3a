"""The port's encoder-decoder (`models/encdec.py`, seamless-m4t-large-v2)
against the JAX package's, on the CPU.

JAX initialises `seamless-smoke` (2 + 2 layers, d_model 64); its biases
and norm scales are zeros there, so the tree is given noise before the
port loads it through `params_from_jax` (a missing or misplaced leaf then
shows).  Parity is in fp32 at 1e-4, and decode against the teacher-forced
`forward` at 2e-3, the reference's own tolerance
(tests/test_models_decode_equiv.py).  The sinusoidal table and its
one-row form, `self_attention` on both routes, the bundle's dict inputs
and the refusals (continuous batching, a prefill offset) are held too.
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
from repro.models import encdec as jax_encdec
from repro_torch.models import common, encdec
from repro_torch.models.frontends import AudioStub
from repro_torch.models.registry import bundle_for
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.scheduler import EngineRequest

ARCH = "seamless-m4t-large-v2"
TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
B, T, S = 2, 12, 7        # batch, speech frames, target tokens
MAX_LEN = 24              # the cross cache (min(24, 32)) outlasts T


def _configs():
    jcfg = dataclasses.replace(jax_configs.get_smoke(ARCH),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(torch_configs.get_smoke(ARCH),
                               dtype=torch.float32)
    return jcfg, tcfg


def _models():
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            np.shape(a)).astype(np.float32),
        jax_encdec.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jparams, tcfg, encdec.params_from_jax(tcfg, jparams, "cpu")


def _inputs(vocab=256, seed=1):
    rng = np.random.default_rng(seed)
    speech = (0.5 * rng.standard_normal((B, T, 64))).astype(np.float32)
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    return speech, tokens


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


def test_configs_match_the_reference():
    for get in ("get", "get_smoke"):
        j, t = getattr(jax_configs, get)(ARCH), getattr(torch_configs,
                                                         get)(ARCH)
        for f in dataclasses.fields(j):
            if f.name != "dtype":
                assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.n_params == j.n_params
        assert t.attn_spec().attn_impl == "naive"
    full = torch_configs.get(ARCH)
    assert full.n_params == 1_370_707_968        # 2.74 GB of bf16
    assert AudioStub().shape(4) == (4, 512, full.d_model)


def test_params_from_jax_keeps_every_leaf():
    jcfg, jparams, tcfg, tparams = _models()
    assert len(tparams["enc_layers"]) == tcfg.n_enc_layers
    assert len(tparams["dec_layers"]) == tcfg.n_dec_layers
    np.testing.assert_array_equal(
        tparams["dec_layers"][1]["cross_attn"]["bk"].numpy(),
        jparams["dec_layers"]["cross_attn"]["bk"][1])
    # The port's own init makes the reference's tree.
    own = encdec.init_params(tcfg, 0, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(lambda: jax_encdec.init_params(
            jcfg, jax.random.PRNGKey(0))))[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        node = own[keys[0]]
        if keys[0] in ("enc_layers", "dec_layers"):
            assert len(node) == leaf.shape[0]
            node, shape = node[0], leaf.shape[1:]
        else:
            shape = leaf.shape
        for k in keys[1:]:
            node = node[k]
        assert tuple(node.shape) == tuple(shape), keys
    with pytest.raises(ValueError, match="enc_layers"):
        encdec.params_from_jax(dataclasses.replace(tcfg, n_enc_layers=3),
                               jparams, "cpu")


def test_encode_and_forward_match_jax():
    jcfg, jparams, tcfg, tparams = _models()
    speech, tokens = _inputs()
    _close(encdec.encode(tcfg, tparams, torch.from_numpy(speech)),
           jax_encdec.encode(jcfg, jparams, jnp.asarray(speech)))
    logits, aux = bundle_for(tcfg).forward(
        tparams, {"speech_embeddings": torch.from_numpy(speech),
                  "tokens": torch.from_numpy(tokens)})
    jlogits, _ = jax_encdec.forward(jcfg, jparams,
                                    (jnp.asarray(speech),
                                     jnp.asarray(tokens)))
    assert logits.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    _close(logits, jlogits)


@pytest.mark.parametrize("max_len", [MAX_LEN, T])
def test_prefill_and_decode_match_jax_and_forward(max_len):
    """BOS through prefill, then every target token through decode_step:
    each step's logits against the JAX step's (1e-4) and against the
    teacher-forced forward's (2e-3).  With MAX_LEN the cross cache is
    longer than the memory, so frames past `memory_len` are masked; with
    T it is exactly the memory.  The port's cache starts dirty, as a
    reused one is: nothing stale may reach an output."""
    jcfg, jparams, tcfg, tparams = _models()
    speech, tokens = _inputs()
    bundle = bundle_for(tcfg)
    inputs = {"speech_embeddings": torch.from_numpy(speech),
              "tokens": torch.from_numpy(tokens)}
    ref_logits, _ = bundle.forward(tparams, inputs)
    cache = bundle.init_cache(B, max_len, "cpu")
    jcache = jax_encdec.init_cache(jcfg, B, max_len)
    assert cache["cross"]["k"].shape == jcache["cross"]["k"].shape
    assert cache["self"]["k"].shape == jcache["self"]["k"].shape
    for leaf in (cache["self"]["k"], cache["self"]["v"],
                 cache["cross"]["k"], cache["cross"]["v"]):
        leaf.normal_(generator=torch.Generator().manual_seed(9))
    logits, cache = bundle.prefill(tparams, inputs, cache,
                                   attn_mask=torch.ones(B, 1, dtype=bool))
    jlogits, jcache = jax_encdec.prefill(
        jcfg, jparams, {"speech_embeddings": jnp.asarray(speech),
                        "tokens": jnp.asarray(tokens)}, jcache)
    assert int(cache["memory_len"]) == T
    _close(logits, jlogits)
    _close(logits, ref_logits[:, 0], DECODE_TOL)
    for i in range(1, S):
        logits, cache = bundle.decode_step(tparams, torch.from_numpy(
            tokens[:, i]), cache, i)
        jlogits, jcache = jax_encdec.decode_step(
            jcfg, jparams, jnp.asarray(tokens[:, i]), jcache,
            jnp.asarray(i, jnp.int32))
        _close(logits, jlogits)
        _close(logits, ref_logits[:, i], DECODE_TOL)


def test_decode_step_with_a_device_position_is_the_int_one():
    """A 0-d position tensor (what a captured step reads) gives the int
    position's logits and cache bit for bit."""
    _, _, tcfg, tparams = _models()
    speech, tokens = _inputs()
    inputs = {"speech_embeddings": torch.from_numpy(speech),
              "tokens": torch.from_numpy(tokens)}
    outs = []
    for as_tensor in (False, True):
        cache = encdec.init_cache(tcfg, B, MAX_LEN, "cpu")
        encdec.prefill(tcfg, tparams, inputs, cache)
        for i in range(1, 4):
            pos = torch.tensor(i) if as_tensor else i
            logits, cache = encdec.decode_step(
                tcfg, tparams, torch.from_numpy(tokens[:, i]), cache, pos)
        outs.append((logits, cache["self"]["k"].clone()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("max_len,dim", [(64, 64), (32768, 1024)])
def test_sinusoidal_table_and_row_match_the_reference(max_len, dim):
    """The table against the reference's, and each row's one-row form
    against the port's table bit for bit.  The frameworks' fp32 `exp`
    round the frequencies (<= 1) a last bit apart at some indices, and an
    angle is fp32(position x frequency), so a row parts from the
    reference's by up to position x 6e-8 plus one fp32 spacing of the
    position (2e-3 at row 32767; ROADMAP Queue 3)."""
    table = common.sinusoidal_positions(max_len, dim)
    ref = np.asarray(jax_common.sinusoidal_positions(max_len, dim))
    assert table.shape == ref.shape == (max_len, dim)
    err = np.abs(table.numpy() - ref).max(axis=1)
    pos = np.arange(max_len, dtype=np.float32)
    bound = pos * 6e-8 + np.spacing(pos) + 1e-6
    assert (err <= bound).all()
    for pos in sorted({0, 1, 7, max_len // 2, max_len - 1}):
        row = common.sinusoidal_position(pos, dim, "cpu")
        assert torch.equal(row[0], table[pos]), pos
        assert torch.equal(common.sinusoidal_position(
            torch.tensor(pos), dim, "cpu"), row)


@pytest.mark.parametrize("route", ["naive", "flash"])
def test_self_attention_routes_match_jax(route):
    """`self_attention` with the reference's routing: "flash" the blocked
    causal attention, "naive" the masked softmax over the given mask or,
    with none, the causal one."""
    rng = np.random.default_rng(3)
    spec = common.AttnSpec(d_model=32, n_heads=4, n_kv_heads=2,
                           head_dim=8, use_bias=True, attn_impl=route)
    jspec = jax_common.AttnSpec(d_model=32, n_heads=4, n_kv_heads=2,
                                head_dim=8, use_bias=True, attn_impl=route)
    jparams = {k: (0.3 * rng.standard_normal(s)).astype(np.float32)
               for k, s in (("wq", (32, 32)), ("wk", (32, 16)),
                            ("wv", (32, 16)), ("wo", (32, 32)),
                            ("bq", (32,)), ("bk", (16,)), ("bv", (16,)),
                            ("bo", (32,)))}
    tparams = {k: torch.from_numpy(v) for k, v in jparams.items()}
    x = rng.standard_normal((2, 10, 32)).astype(np.float32)
    pos = np.tile(np.arange(10), (2, 1))
    masks = [None]
    if route == "naive":
        masks.append(np.ones((1, 10, 10), bool))
    for mask in masks:
        out = common.self_attention(
            tparams, spec, torch.from_numpy(x), torch.from_numpy(pos),
            None if mask is None else torch.from_numpy(mask))
        ref = jax_common.self_attention(jparams, jspec, jnp.asarray(x),
                                        jnp.asarray(pos), mask)
        _close(out, ref)


def test_encdec_refuses_continuous_batching_and_offsets():
    _, _, tcfg, tparams = _models()
    bundle = bundle_for(tcfg)
    assert bundle.family == "encdec"
    engine = InferenceEngine(bundle, tparams, max_batch=2, max_seq_len=32,
                             device="cpu")
    req = EngineRequest(rid=0, prompt=np.ones(4, np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="encdec"):
        engine.generate_continuous([req])
    speech, tokens = _inputs()
    with pytest.raises(NotImplementedError, match="pos_offset"):
        bundle.prefill(tparams, (torch.from_numpy(speech),
                                 torch.from_numpy(tokens)),
                       bundle.init_cache(B, MAX_LEN, "cpu"), pos_offset=4)
