"""The port's one-card dry run (`repro_torch.launch.dryrun`): every cell
on the meta device with nothing allocated, its counts and model FLOPs
against the reference's bundle and formula, its skipped cells the
reference's, and the training-step memory estimate's bookkeeping."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import repro.configs as jax_configs
from repro.models.registry import bundle_for as jax_bundle_for
import repro_torch.configs as torch_configs
from repro_torch.configs.specs import SHAPES
from repro_torch.launch import dryrun

ALL_ARCHS = jax_configs.ARCHS + jax_configs.EDGE_MODELS


class _Devices(TorchDispatchMode):
    """The devices of every tensor an op makes under it, 0-d constants
    (a model's scalar factors, made on the CPU) left out."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.seen.update(t.device.type for t in tree_leaves(out)
                         if isinstance(t, torch.Tensor) and t.dim())
        return out


def _reference_useful(arch, shape):
    """The reference dry run's `useful` on one chip (its lower_cell)."""
    spec = jax_configs.input_specs(arch, shape)
    bundle = jax_bundle_for(jax_configs.get(arch))
    n_active = bundle.n_active_params
    eff_seq = spec.seq_len
    if bundle.family == "encdec" and spec.kind == "prefill":
        eff_seq = min(spec.seq_len, bundle.cfg.max_source_len) + 1
    if spec.kind == "train":
        return 6.0 * n_active * spec.batch * eff_seq
    if spec.kind == "prefill":
        return 2.0 * n_active * spec.batch * eff_seq
    return 2.0 * n_active * spec.batch * 1


def test_every_record_is_written_with_nothing_allocated(tmp_path, capsys):
    with _Devices() as mode:
        rc = dryrun.main(["--all", "--no-train-memory", "--out-dir",
                          str(tmp_path)])
    assert rc == 0
    assert mode.seen == {"meta"}
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == len(ALL_ARCHS) * len(SHAPES)
    statuses = {json.loads(f.read_text())["status"] for f in files}
    assert statuses == {"ok", "skipped"}
    assert "[ok] llama32_1b x train_4k" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_records_follow_the_reference(arch):
    ref = jax_bundle_for(jax_configs.get(arch))
    for shape in SHAPES:
        rec = dryrun.cell(arch, shape, train_memory=False)
        if jax_configs.input_specs(arch, shape) is None:
            assert rec == {"arch": arch, "shape": shape,
                           "status": "skipped",
                           "reason": dryrun.SKIP_REASON}
            continue
        assert rec["status"] == "ok"
        assert (rec["n_params"], rec["n_active_params"]) == \
            (ref.n_params, ref.n_active_params)
        useful = _reference_useful(arch, shape)
        assert rec["cost"]["flops"] == useful
        assert rec["roofline"]["model_flops_per_device"] == useful
        assert rec["roofline"]["compute_s"] == useful / dryrun.PEAK_FLOPS
        h = rec["hbm_analytic"]
        assert h["fits_80g"] == (h["need_bytes"] < dryrun.HBM_BYTES)
        if rec["kind"] == "train":
            assert h["opt_bytes_per_dev"] == 8 * sum(
                t.numel() for t in _abstract(arch))
        else:
            assert h["cache_bytes_per_dev"] > 0


def _abstract(arch):
    from repro_torch.models.registry import bundle_for
    from repro_torch.training import tree as tree_mod
    return tree_mod.leaves(bundle_for(torch_configs.get(arch))
                           .abstract_params())


def test_live_bytes_counts_storages_once_in_allocator_blocks():
    meter = dryrun.LiveBytes()
    with meter:
        a = torch.empty(1000, device="meta")          # 4000 B -> 4096
        view = a[10:20]
        b = torch.empty((3, 3), dtype=torch.bfloat16, device="meta")
        assert meter.live == 4096 + 512
        del a, view
        assert meter.live == 512
        c = b.add_(1)                                 # in place: no new
        assert meter.live == 512 and c is b
    assert meter.peak == 4096 + 512


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b", "rwkv6-3b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_train_step_memory_on_the_meta_device(arch):
    """The step runs on the meta device, through every kernel's card route
    (nothing launched or counted); its parameters, gradients and AdamW
    state are what the config holds, its peak holds them all, and remat
    keeps less for the backward than none where the family recomputes
    (the transformer and rwkv6; recurrentgemma and the encoder-decoder
    read no remat policy, as in the reference)."""
    from repro_torch.kernels import backward_launch_counts, launch_counts
    cfg = torch_configs.get_smoke(arch)
    before = (launch_counts(), backward_launch_counts())
    with _Devices() as mode:
        est = dryrun.train_step_memory(cfg, 2, 32)
    assert mode.seen == {"meta"}
    assert (launch_counts(), backward_launch_counts()) == before
    n = sum(t.numel() for t in _smoke_leaves(cfg))
    param_bytes = sum(t.numel() * t.element_size()
                      for t in _smoke_leaves(cfg))
    assert est["weights"] == est["grads"] == param_bytes
    assert est["adamw"] == 8 * n
    assert est["activations"] > 0
    assert est["peak"] >= est["weights"] + est["adamw"] + est["activations"]
    full = dryrun.train_step_memory(cfg, 2, 32, remat="full")
    assert full["remat"] == "full"
    if arch in ("recurrentgemma-9b", "seamless-m4t-large-v2"):
        assert full == dict(est, remat="full")
    else:
        assert full["activations"] < est["activations"]


def _smoke_leaves(cfg):
    from repro_torch.models.registry import bundle_for
    from repro_torch.training import tree as tree_mod
    return tree_mod.leaves(bundle_for(cfg).abstract_params())


def test_train_memory_cli_and_a_cut_config(capsys):
    assert dryrun.main(["--train-memory", "olmoe-1b-7b", "--layers", "2",
                        "--batch", "2", "--seq-len", "64"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cut = dataclasses.replace(torch_configs.get("olmoe-1b-7b"), n_layers=2)
    assert out["layers"] == 2
    assert out == {"arch": "olmoe-1b-7b", "layers": 2,
                   **dryrun.train_step_memory(cut, 2, 64)}


def test_meta_tensors_take_the_card_route_only_in_a_dry_run():
    """Outside `_build.dry_run` the training kernels' wrappers refuse a
    meta tensor; inside, each returns its outputs' shapes on the meta
    device and launches and counts nothing."""
    from repro_torch.kernels import _build, backward_launch_counts
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.moe_gemm import ops as mg_ops
    from repro_torch.kernels.rglru import ops as rg_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rwkv6 import ops as wk_ops

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(shape, dtype=dtype, device="meta")
    f32 = torch.float32
    calls = {
        "rmsnorm": lambda: rms_ops.rmsnorm(meta(4, 64), meta(64)),
        "grouped_gemm": lambda: mg_ops.grouped_gemm(meta(2, 8, 16),
                                                    meta(2, 16, 24)),
        "wkv6": lambda: wk_ops.wkv6(
            meta(2, 32, 4, 64), meta(2, 32, 4, 64), meta(2, 32, 4, 64),
            meta(2, 32, 4, 64, dtype=f32), meta(4, 64, dtype=f32),
            meta(2, 4, 64, 64, dtype=f32)),
        "rglru_gated": lambda: rg_ops.rglru_gated(
            meta(2, 16, 64), meta(2, 16, 64), meta(2, 16, 64),
            meta(64, dtype=f32), meta(64, dtype=f32), meta(64, dtype=f32),
            meta(2, 64, dtype=f32)),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError):
            call()
    before = (launch_counts(), backward_launch_counts())
    with _build.dry_run():
        shapes = {name: tuple(tree_leaves(call())[0].shape)
                  for name, call in calls.items()}
    assert not _build.on_card(torch.device("meta"))
    assert shapes == {"rmsnorm": (4, 64), "grouped_gemm": (2, 8, 24),
                      "wkv6": (2, 32, 4, 64), "rglru_gated": (2, 16, 64)}
    assert (launch_counts(), backward_launch_counts()) == before


def test_train_step_memory_takes_a_specs_prefix():
    """A training cell's inputs come from its dry-run spec: phi-3's patch
    embeddings ride along, are counted, and reach the head's RMSNorm
    kernel route as whole rows once the prefix is cut off."""
    cfg = torch_configs.get_smoke("phi-3-vision-4.2b")
    meta = dict(dtype=torch.int32, device="meta")
    inputs = {"tokens": torch.empty((2, 32), **meta),
              "labels": torch.empty((2, 32), **meta),
              "prefix_embeddings": torch.empty(
                  (2, cfg.num_prefix_embeddings, cfg.d_model),
                  dtype=cfg.dtype, device="meta")}
    with_prefix = dryrun.train_step_memory(cfg, 2, 32, inputs=inputs)
    tokens_only = dryrun.train_step_memory(cfg, 2, 32)
    assert with_prefix["activations"] > tokens_only["activations"]
    assert with_prefix["peak"] > tokens_only["peak"]
    rec = dryrun.cell("phi-3-vision-4.2b", "train_4k", train_memory=False)
    assert rec["status"] == "ok"
