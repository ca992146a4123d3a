"""The port's training path (models' `loss_fn`, `abstract_params` and
remat, `training/*`, `launch/steps.py`, `launch/train.py`) against the JAX
package's, on the CPU.

- `loss_fn` and every leaf's gradient against `jax.value_and_grad` of the
  reference's, on llama3.2-1b-smoke and olmoe-1b-7b-smoke in fp32 with the
  reference's weights (`params_from_jax`), naive and flash attention, at
  1e-4 (the port's model tolerance).  The CPU runs the kernels' plain
  versions; tests/test_torch_cuda.py holds the backward kernels to them on
  the card.
- remat "dots" and "full" against "none".
- AdamW against the reference's over several steps, fp32 and bf16, on a
  tree whose per-layer leaves the reference stacks (its weight decay of
  every layer's 1-D leaves included).
- `make_train_step` for 5 steps on the reference's `SyntheticLM` batches:
  losses and params against JAX's `make_train_step`.
- The reference's training-substrate tests (tests/test_training_substrate.py)
  restated on the port, a checkpoint of a plain tree written by each
  package restored by the other, and the int8 codec's codes and scales
  equal to the reference's.
"""

import dataclasses
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.configs as jax_configs
import repro_torch.configs as torch_configs
from repro.kernels.moe_gemm.ref import moe_gemm_ref as jax_moe_gemm_ref
from repro.launch import steps as jax_steps
from repro.models import common as jax_common
from repro.models.registry import bundle_for as jax_bundle_for
from repro.training import checkpoint as jax_ck
from repro.training import compression as jax_comp
from repro.training import optimizer as jax_opt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import SyntheticLM as JaxSyntheticLM
from repro_torch.kernels.moe_gemm import ops as mg_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.launch import steps, train
from repro_torch.models import common, transformer
from repro_torch.models.registry import bundle_for
from repro_torch.training import checkpoint as ck
from repro_torch.training import compression as comp
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import tree
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.elastic import (StragglerWatchdog, reshard_plan,
                                          shrink_data_axis)

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _models(arch: str, attn_impl: str = "naive"):
    jcfg = dataclasses.replace(jax_configs.get_smoke(arch),
                               dtype=jnp.float32, attn_impl=attn_impl)
    tcfg = dataclasses.replace(torch_configs.get_smoke(arch),
                               dtype=torch.float32, attn_impl=attn_impl)
    jb = jax_bundle_for(jcfg)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    tparams = transformer.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jb, jparams, bundle_for(tcfg), tparams


def _batch(vocab: int, b: int = 2, s: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _unstack(n_layers, jtree):
    """A JAX tree with stacked layers as the port's tree of fp32 tensors."""
    return common.params_from_jax_tree(
        jax.tree.map(np.asarray, jtree), {"layers": n_layers},
        lambda key: torch.float32, torch.device("cpu"))


def _torch_grads(bundle, params, batch):
    flat = tree.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = bundle.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, flat)
    for p in flat:
        p.requires_grad_(False)
    return loss, tree.unflatten(params, list(grads))


# ---------------------------------------------------------------------------
# loss_fn, gradients, remat, abstract_params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["naive", "flash"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b"])
def test_loss_and_every_grad_match_jax(arch, attn_impl):
    jb, jparams, tb, tparams = _models(arch, attn_impl)
    batch = _batch(tb.cfg.vocab_size)
    jloss, jgrads = jax.jit(jax.value_and_grad(jb.loss_fn))(jparams, batch)
    loss, grads = _torch_grads(tb, tparams, _torch_batch(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    ref = _unstack(tb.cfg.n_layers, jgrads)
    got, want = tree.flatten_with_paths(grads), tree.flatten_with_paths(ref)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert len(got) == (20 if arch == "llama3.2-1b" else 27)
    for (path, g), (_, r) in zip(got, want):
        assert float(r.abs().max()) > 0, path
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=path, **TOL)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_matches_none(remat):
    """Recomputing each block in the backward changes no value: loss and
    gradients equal the run without remat (olmoe-smoke: qk-norm, MoE)."""
    _, _, tb, tparams = _models("olmoe-1b-7b")
    batch = _torch_batch(_batch(tb.cfg.vocab_size, seed=1))
    loss, grads = _torch_grads(tb, tparams, batch)
    rb = bundle_for(dataclasses.replace(tb.cfg, remat=remat))
    rloss, rgrads = _torch_grads(rb, tparams, batch)
    assert rloss.item() == loss.item()
    for a, b in zip(tree.leaves(rgrads), tree.leaves(grads)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(tb.cfg, remat="some")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b"])
def test_abstract_params_match_init_and_the_reference(arch):
    tcfg = torch_configs.get_smoke(arch)
    abstract = bundle_for(tcfg).abstract_params()
    real = bundle_for(tcfg).init_params(0, "cpu")
    a, r = tree.flatten_with_paths(abstract), tree.flatten_with_paths(real)
    assert [k for k, _ in a] == [k for k, _ in r]
    for (path, x), (_, y) in zip(a, r):
        assert x.device.type == "meta", path
        assert (x.shape, x.dtype) == (y.shape, y.dtype), path
    jp = jax_bundle_for(jax_configs.get_smoke(arch)).abstract_params()
    shapes = jax.tree.map(lambda s: tuple(s.shape[1:]), jp["layers"])
    for lp in abstract["layers"]:
        assert jax.tree.map(lambda t: tuple(t.shape), lp) == shapes


def test_rmsnorm_backward_plain_version_matches_jax():
    """`rmsnorm_backward` (its plain version on the CPU) against
    jax.vjp of the reference's norm, and against torch autograd."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    s = 0.1 * rng.standard_normal(96).astype(np.float32)
    dy = rng.standard_normal((3, 5, 96)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_common.rmsnorm({"scale": b}, a),
                     jnp.asarray(x), jnp.asarray(s))
    jdx, jds = vjp(jnp.asarray(dy))
    before = rms_ops.bwd_launches
    dx, ds = rms_ops.rmsnorm_backward(_t(dy), _t(x), _t(s))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), rtol=1e-5,
                               atol=1e-5)
    xt, st_ = _t(x).requires_grad_(True), _t(s).requires_grad_(True)
    rms_ops.rmsnorm(xt, st_).backward(_t(dy))
    torch.testing.assert_close(xt.grad, dx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st_.grad, ds, rtol=1e-5, atol=1e-5)
    assert rms_ops.bwd_launches == before   # the CPU path launches nothing


def test_grouped_gemm_backward_plain_version_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 13, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32, 48)).astype(np.float32)
    dy = rng.standard_normal((4, 13, 48)).astype(np.float32)
    _, vjp = jax.vjp(jax_moe_gemm_ref, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(mg_ops.grouped_gemm_dx(_t(dy), _t(w)).numpy(),
                               np.asarray(jdx), **TOL)
    np.testing.assert_allclose(mg_ops.grouped_gemm_dw(_t(x), _t(dy)).numpy(),
                               np.asarray(jdw), **TOL)
    xt, wt = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    mg_ops.grouped_gemm(xt, wt).backward(_t(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), **TOL)


# ---------------------------------------------------------------------------
# AdamW and the train step
# ---------------------------------------------------------------------------

def _opt_trees(dtype_name: str, seed: int = 0):
    """The same params and 4 steps of gradients as a JAX tree (layers
    stacked) and the port's (layers a list)."""
    rng = np.random.default_rng(seed)
    L, D, V = 3, 8, 16

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    jp = {"embedding": a(V, D), "final_norm": {"scale": 0.1 * a(D)},
          "layers": {"norm": {"scale": 0.1 * a(L, D)}, "w": a(L, D, D),
                     "b": 0.1 * a(L, D)}}
    jg = [jax.tree.map(lambda x: 0.5 * rng.standard_normal(x.shape)
                       .astype(np.float32), jp) for _ in range(4)]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype_name]
    tdt = getattr(torch, dtype_name)

    def port(t):
        return {"embedding": _t(t["embedding"]),
                "final_norm": {"scale": _t(t["final_norm"]["scale"])},
                "layers": [{"norm": {"scale": _t(t["layers"]["norm"]
                                                 ["scale"][i])},
                            "w": _t(t["layers"]["w"][i]),
                            "b": _t(t["layers"]["b"][i])} for i in range(L)]}
    tp = tree.tree_map(lambda x: x.to(tdt), port(jp))
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), jp)
    return jp, jg, tp, [port(g) for g in jg]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_adamw_matches_the_reference_with_stacked_decay(dtype_name):
    """Four AdamW steps on the same params and gradients.  The reference
    decays its stacked per-layer leaves (norm scales, biases: [L, D]) and
    not the final norm ([D]); the port's per-layer [D] leaves decay too."""
    cfg = opt_mod.AdamWConfig(lr=1e-2, weight_decay=0.5, warmup_steps=2,
                              total_steps=6)
    jcfg = jax_opt.AdamWConfig(**dataclasses.asdict(cfg))
    jp, jg, tp, tg = _opt_trees(dtype_name)
    jstate, tstate = jax_opt.init(jp), opt_mod.init(tp)
    for step in range(4):
        jp, jstate, jm = jax_opt.apply(jcfg, jp, jg[step], jstate)
        tp, tstate, tm = opt_mod.apply(cfg, tp, tg[step], tstate)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 4
    # bf16 params: one rounding of the same fp32 update (an ulp apart at
    # most where the fp32 values straddle a rounding boundary).
    tol = dict(rtol=1e-6, atol=1e-6) if dtype_name == "float32" else \
        dict(rtol=8e-3, atol=1e-5)
    want = _unstack(3, jp)
    for (path, got), (_, ref) in zip(tree.flatten_with_paths(tp),
                                     tree.flatten_with_paths(want)):
        assert got.dtype == getattr(torch, dtype_name)
        np.testing.assert_allclose(got.float().numpy(), ref.numpy(),
                                   err_msg=path, **tol)
    for name, m in (("m", tstate.m), ("v", tstate.v)):
        ref = _unstack(3, getattr(jstate, name))
        for (path, got), (_, r) in zip(tree.flatten_with_paths(m),
                                       tree.flatten_with_paths(ref)):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), r.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} {path}")
    assert opt_mod.decays("layers/0/norm/scale", tp["layers"][0]["b"])
    assert not opt_mod.decays("final_norm/scale", tp["final_norm"]["scale"])


def test_train_step_matches_jax_over_five_steps():
    """Five steps of `make_train_step` on olmoe-smoke against JAX's on the
    reference's SyntheticLM batches: losses at 1e-4, params at 1e-4."""
    jb, jparams, tb, tparams = _models("olmoe-1b-7b")
    cfg = opt_mod.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=5)
    jcfg = jax_opt.AdamWConfig(**dataclasses.asdict(cfg))
    data = JaxSyntheticLM(JaxDataConfig(vocab_size=tb.cfg.vocab_size,
                                        seq_len=16, global_batch=2, seed=3))
    jstep = jax.jit(jax_steps.make_train_step(jb, jcfg))
    tstep = steps.make_train_step(tb, cfg)
    jstate, tstate = jax_opt.init(jparams), opt_mod.init(tparams)
    for i in range(5):
        batch = jax.tree.map(np.asarray, data.batch(i))
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        tparams, tstate, tm = tstep(tparams, tstate, _torch_batch(batch))
        assert set(tm) == {"loss", "grad_norm", "lr"}
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   **TOL)
    for (path, got), (_, ref) in zip(
            tree.flatten_with_paths(tparams),
            tree.flatten_with_paths(_unstack(tb.cfg.n_layers, jparams))):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), err_msg=path,
                                   **TOL)


def test_compressed_train_step_runs_the_transform():
    """`compress_grads` sees the gradient tree and its result is what
    AdamW applies."""
    _, _, tb, tparams = _models("llama3.2-1b")
    seen = []

    def compress(grads):
        seen.append(grads)
        return tree.tree_map(torch.zeros_like, grads)
    before = tree.tree_map(torch.clone, tparams)
    cfg = opt_mod.AdamWConfig(weight_decay=0.0)
    step = steps.make_train_step(tb, cfg, compress_grads=compress)
    params, state, _ = step(tparams, opt_mod.init(tparams),
                            _torch_batch(_batch(tb.cfg.vocab_size)))
    assert len(seen) == 1 and int(state.step) == 1
    for a, b in zip(tree.leaves(params), tree.leaves(before)):
        assert torch.equal(a, b)


def test_train_step_raises_on_a_leaf_the_loss_misses():
    """A leaf without a gradient is a cut graph (a kernel with no
    backward), so the step raises instead of applying a zero update."""
    _, _, tb, tparams = _models("llama3.2-1b")
    tparams["unused"] = torch.zeros((4, 4))
    step = steps.make_train_step(tb, opt_mod.AdamWConfig())
    with pytest.raises(RuntimeError, match="not have been used"):
        step(tparams, opt_mod.init(tparams),
             _torch_batch(_batch(tb.cfg.vocab_size)))


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn((4, 8), generator=g),
            "b16": torch.randn((3,), generator=g).to(torch.bfloat16),
            "nested": {"step": torch.tensor(7, dtype=torch.int32)}}


def _jax_tree(seed=0):
    k = jax.random.PRNGKey(seed)
    return {"w": jax.random.normal(k, (4, 8), jnp.float32),
            "b16": jax.random.normal(k, (3,), jnp.float32
                                     ).astype(jnp.bfloat16),
            "nested": {"step": jnp.asarray(7, jnp.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    ck.save(tmp_path, 5, t, extra={"data_step": 5})
    restored, extra = ck.restore(tmp_path, 5, tree.tree_map(
        lambda x: x.to("meta"), t))
    assert extra["data_step"] == 5
    for a, b in zip(tree.leaves(t), tree.leaves(restored)):
        assert a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)


def test_checkpoint_keep_n(tmp_path):
    t = _tree()
    for s in range(6):
        ck.save(tmp_path, s, t, keep=2)
    assert ck.available_steps(tmp_path) == [4, 5]


def test_restore_latest_skips_torn(tmp_path):
    t = _tree()
    ck.save(tmp_path, 1, t)
    ck.save(tmp_path, 2, t)
    (tmp_path / "step_0000000002" / "manifest.json").write_text("{")
    got = ck.restore_latest(tmp_path, t)
    assert got is not None and got[0] == 1


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ck.save(tmp_path, 1, _tree())
    bad = {"w": torch.zeros((2, 2)), "b16": torch.zeros(3, dtype=torch.bfloat16),
           "nested": {"step": torch.tensor(0)}}
    with pytest.raises(ValueError, match="shape"):
        ck.restore(tmp_path, 1, bad)


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    t = _tree()
    ck.save(tmp_path, 3, t, extra={"data_step": 3})
    template = jax.eval_shape(lambda: jax.tree.map(
        lambda x: jnp.zeros(x.shape, {torch.float32: jnp.float32,
                                      torch.bfloat16: jnp.bfloat16,
                                      torch.int32: jnp.int32}[x.dtype]), t))
    restored, extra = jax_ck.restore(tmp_path, 3, template)
    assert extra == {"data_step": 3}
    assert restored["b16"].dtype == jnp.bfloat16
    for (path, a), (_, b) in zip(tree.flatten_with_paths(t),
                                 tree.flatten_with_paths(restored)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32), path)


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    t = _jax_tree()
    jax_ck.save(tmp_path, 4, t, extra={"data_step": 4})
    template = tree.tree_map(lambda x: x.to("meta"), _tree())
    got = ck.restore_latest(tmp_path, template)
    assert got is not None and got[0] == 4 and got[2] == {"data_step": 4}
    restored = got[1]
    assert restored["b16"].dtype == torch.bfloat16
    assert restored["nested"]["step"].dtype == torch.int32
    for (path, a), (_, b) in zip(tree.flatten_with_paths(restored),
                                 tree.flatten_with_paths(t)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32), path)


def test_checkpoint_keys_are_the_reference_paths(tmp_path):
    """Dict keys, list indices and NamedTuple fields, as JAX names them."""
    state = opt_mod.init({"layers": [{"w": torch.zeros(2)}]})
    t = ({"layers": [{"w": torch.zeros(2)}]}, state)
    keys = [k for k, _ in tree.flatten_with_paths(t)]
    jt = ({"layers": [{"w": jnp.zeros(2)}]}, jax_opt.init(
        {"layers": [{"w": jnp.zeros(2)}]}))
    jkeys = [k for k, _ in jax_ck._flatten_with_paths(jt)]
    assert keys == jkeys == ["0/layers/0/w", "1/step", "1/m/layers/0/w",
                             "1/v/layers/0/w"]


def test_train_crash_and_resume(tmp_path):
    """Injected failure mid-training; a rerun resumes from the checkpoint
    and continues to the target step with the uninterrupted run's
    losses."""
    kw = dict(smoke=True, steps=10, global_batch=2, seq_len=16,
              log_every=100, device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        train.run_training("smollm-360m", ckpt_dir=str(tmp_path),
                           ckpt_every=2, fail_at_step=5, **kw)
    out = train.run_training("smollm-360m", ckpt_dir=str(tmp_path),
                             ckpt_every=2, **kw)
    assert out["start_step"] >= 4          # resumed, not restarted
    assert out["start_step"] + out["steps_run"] == 10
    whole = train.run_training("smollm-360m", **kw)
    np.testing.assert_allclose(out["losses"],
                               whole["losses"][out["start_step"]:],
                               rtol=1e-6)
    assert whole["losses"][-1] < whole["losses"][0]


@pytest.mark.parametrize("fail_at_step", [-1, 1])
def test_run_training_restores_the_sigterm_handler(tmp_path, fail_at_step):
    """The emergency-save handler lasts as long as the run, whether it
    ends or raises: afterwards SIGTERM is handled as it was before."""
    def before(signum, frame):
        pass
    old = signal.signal(signal.SIGTERM, before)
    try:
        try:
            train.run_training("smollm-360m", smoke=True, steps=2,
                               global_batch=2, seq_len=8, log_every=100,
                               device="cpu", ckpt_dir=str(tmp_path),
                               fail_at_step=fail_at_step)
        except RuntimeError as e:
            assert fail_at_step >= 0 and "injected failure" in str(e)
        assert signal.getsignal(signal.SIGTERM) is before
    finally:
        signal.signal(signal.SIGTERM, old)


def test_run_training_takes_one_card_only():
    with pytest.raises(NotImplementedError, match="9c"):
        train.run_training("smollm-360m", steps=1, model_parallel=2,
                           device="cpu")


def test_train_cli_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
        "--steps", "3", "--global-batch", "2", "--seq-len", "8",
        "--remat", "full"])
    train.main()
    out = capsys.readouterr().out
    assert "[train] done:" in out and "'steps_run': 3" in out


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_deterministic_and_resumable():
    cfg = DataConfig(vocab_size=512, seq_len=16, global_batch=4, seed=3)
    d1, d2 = SyntheticLM(cfg), SyntheticLM(cfg)
    assert torch.equal(d1.batch(7)["tokens"], d2.batch(7)["tokens"])
    assert not torch.equal(d1.batch(7)["tokens"], d1.batch(8)["tokens"])
    it = d1.iterate(7)
    assert torch.equal(next(it)["labels"], d2.batch(7)["labels"])


def test_data_host_shards_partition_global_batch():
    cfg = DataConfig(vocab_size=512, seq_len=8, global_batch=8)
    d = SyntheticLM(cfg)
    full = d.batch(0)["tokens"]
    parts = [d.host_shard(0, i, 4)["tokens"] for i in range(4)]
    assert torch.equal(torch.cat(parts), full)


def test_data_labels_are_shifted_tokens():
    cfg = DataConfig(vocab_size=128, seq_len=12, global_batch=2)
    b = SyntheticLM(cfg).batch(0)
    assert b["tokens"].shape == (2, 12) and b["tokens"].dtype == torch.int32
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_matches_the_reference_in_distribution():
    """Token frequencies of the port's stream against the reference's (a
    different random stream, the same Zipf logits and EOS rate)."""
    cfg = dict(vocab_size=64, seq_len=256, global_batch=16, seed=0)
    port = SyntheticLM(DataConfig(**cfg))
    ref = JaxSyntheticLM(JaxDataConfig(**cfg))
    np.testing.assert_allclose(port._logits.numpy(), np.asarray(ref._logits),
                               rtol=1e-6)
    p = np.bincount(np.concatenate([port.batch(s)["tokens"].numpy().ravel()
                                    for s in range(4)]), minlength=64)
    r = np.bincount(np.concatenate([np.asarray(ref.batch(s)["tokens"]).ravel()
                                    for s in range(4)]), minlength=64)
    np.testing.assert_allclose(p / p.sum(), r / r.sum(), atol=0.01)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

@settings(max_examples=15, deadline=None)
@given(st.integers(0, 1000), st.floats(0.01, 100.0))
def test_quantize_error_bound(seed, scale):
    x = scale * torch.randn(777, generator=torch.Generator().manual_seed(seed))
    rt = comp.roundtrip(x)
    assert float((rt - x).abs().max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_codec_codes_and_scales_equal_the_reference():
    """Codes and scales bit for bit, rounding half to even included."""
    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal(777)).astype(np.float32)
    x[:4] = [127.0, 2.5, -3.5, 0.5]      # scale 1: ties at 2.5, -3.5, 0.5
    codes, scale = comp.quantize(torch.from_numpy(x))
    jcodes, jscale = jax_comp.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert codes[0, :4].tolist() == [127, 2, -4, 0]
    np.testing.assert_array_equal(
        comp.roundtrip(torch.from_numpy(x)).numpy(),
        np.asarray(jax_comp.roundtrip(jnp.asarray(x))))


def test_error_feedback_unbiased_over_time():
    g = {"w": 0.01 * torch.randn(512, generator=torch.Generator()
                                 .manual_seed(0))}
    err = comp.init_error_state(g)
    total = torch.zeros(512)
    for _ in range(50):
        q, err = comp.compressed_grads(g, err)
        total = total + q["w"]
    true_total = g["w"] * 50
    assert float((total - true_total).norm() / true_total.norm()) < 0.02


def test_compression_ratio():
    g = {"w": torch.zeros(1 << 16)}
    assert comp.stats(g).ratio > 3.5
    jg = {"w": jnp.zeros(1 << 16)}
    assert comp.stats(g) == comp.CompressionStats(
        **dataclasses.asdict(jax_comp.stats(jg)))


# ---------------------------------------------------------------------------
# elastic / straggler
# ---------------------------------------------------------------------------

def test_shrink_data_axis():
    assert shrink_data_axis(240, 16) == (15, 16)
    with pytest.raises(ValueError):
        shrink_data_axis(8, 16)


def test_reshard_plan():
    plan = reshard_plan((16, 16), 240)
    assert plan["new"] == {"data": 15, "model": 16}
    assert plan["chips_lost"] == 16
    assert np.isclose(plan["global_batch_scale"], 15 / 16)


def test_watchdog_flags_straggler():
    wd = StragglerWatchdog(warmup_steps=5, z_threshold=3.0, patience=2)
    flagged = []
    for step in range(30):
        dur = 0.1 + 0.001 * (step % 3)
        if step in (20, 21, 22):
            dur = 1.5
        flagged.append(wd.observe(step, dur))
    assert flagged[20] and flagged[21]
    assert wd.should_escalate or flagged[22]
    assert not any(flagged[6:20])


# ---------------------------------------------------------------------------
# optimizer basics
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    cfg = opt_mod.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                              total_steps=200, grad_clip=10.0)
    params = {"x": torch.tensor([5.0, -3.0])}
    state = opt_mod.init(params)
    for _ in range(150):
        grads = {"x": 2.0 * params["x"]}
        params, state, _ = opt_mod.apply(cfg, params, grads, state)
    assert float(params["x"].abs().max()) < 0.2


def test_grad_clip_and_lr_schedule():
    cfg = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = jax_opt.AdamWConfig(**dataclasses.asdict(cfg))
    for s in (0, 1, 10, 37, 100, 150):
        np.testing.assert_allclose(
            opt_mod.lr_at(cfg, torch.tensor(s)).item(),
            float(jax_opt.lr_at(jcfg, jnp.asarray(s))), rtol=1e-6)
    assert opt_mod.lr_at(cfg, torch.tensor(0)).item() == 0.0
    g = {"x": torch.tensor([3.0, 4.0])}
    clipped, norm = opt_mod.clip_by_global_norm(g, 1.0)
    assert np.isclose(float(norm), 5.0)
    assert np.isclose(float(clipped["x"].norm()), 1.0)
