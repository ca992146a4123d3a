"""The port's sharding specs (`repro_torch.distributed.sharding`), device
meshes (`launch/mesh.py`) and ring model (`distributed/collectives.py`)
against the reference's.

The reference stacks each layer group on a leading axis and the port keeps
a leaf a layer, so a port leaf under a layer index is held to the
reference's spec with its leading (layer) entry dropped; the caches are
stacked in both and held as they are.  Meshes shaped like the reference's
pods are given as axis sizes: no device is needed."""

from __future__ import annotations

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.distributed import collectives as jax_coll
from repro.distributed import sharding as jax_sh
from repro.models.registry import bundle_for as jax_bundle_for
import repro_torch.configs as torch_configs
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.registry import bundle_for
from repro_torch.training import tree as tree_mod

ALL_ARCHS = jax_configs.ARCHS + jax_configs.EDGE_MODELS
#: Meshes shaped like the reference's: a pod, two pods, a small host mesh.
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16},
          "small": {"data": 4, "model": 2}}


def _full(spec, ndim):
    """A PartitionSpec written out to `ndim` entries, as the port's."""
    return tuple(spec) + (None,) * (ndim - len(spec))


def _ref_leaves(tree):
    return {jax_sh._path_str(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _hold_param_specs(jcfg, tcfg, msize, axes_pair=None):
    jaxes, taxes = axes_pair or (jax_sh.Axes(), sharding.Axes())
    jb, tb = jax_bundle_for(jcfg), bundle_for(tcfg)
    want = _ref_leaves(jax_sh.param_pspecs(jb, jaxes, msize))
    shapes = {p: leaf.shape for p, leaf in _ref_leaves(
        jb.abstract_params()).items()}
    got = sharding.spec_items(sharding.param_pspecs(tb, taxes, msize))
    abstract = dict(tree_mod.flatten_with_paths(tb.abstract_params()))
    assert [p for p, _ in got] == list(abstract)
    covered = set()
    for path, spec in got:
        ref_path = sharding._rule_path(path)
        covered.add(ref_path)
        ref = _full(want[ref_path], len(shapes[ref_path]))
        stacked = ref_path != path
        assert len(spec) == abstract[path].dim(), path
        if stacked:
            assert tuple(shapes[ref_path][1:]) == tuple(abstract[path].shape)
            assert spec == ref[1:], (path, spec, ref)
        else:
            assert tuple(shapes[ref_path]) == tuple(abstract[path].shape)
            assert spec == ref, (path, spec, ref)
    assert covered == set(want)


@pytest.mark.parametrize("msize", [1, 4, 16])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_the_reference_smoke(arch, msize):
    _hold_param_specs(jax_configs.get_smoke(arch),
                      torch_configs.get_smoke(arch), msize)


@pytest.mark.parametrize("arch,shard_mode", [
    ("llama3.2-1b", None), ("olmoe-1b-7b", "expert"), ("olmoe-1b-7b", "ffn")])
def test_param_specs_match_the_reference_full(arch, shard_mode):
    jcfg, tcfg = jax_configs.get(arch), torch_configs.get(arch)
    if shard_mode:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, shard_mode=shard_mode))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, shard_mode=shard_mode))
    _hold_param_specs(jcfg, tcfg, 16)
    # The multi-pod axes leave parameters as on one pod.
    _hold_param_specs(jcfg, tcfg, 16, (
        jax_sh.Axes(data=("pod", "data")),
        sharding.Axes.for_mesh(MESHES["multi"])))


def test_opt_specs_mirror_the_params():
    tb = bundle_for(torch_configs.get_smoke("olmoe-1b-7b"))
    p = sharding.param_pspecs(tb, sharding.Axes(), 4)
    o = sharding.opt_pspecs(tb, sharding.Axes(), 4)
    assert o.step == () and o.m == p and o.v == p
    items = dict(sharding.spec_items(o))
    assert items["step"] == ()
    assert items["m/layers/0/moe/w_gate"] == ("model", None, None)


def _fake_mesh(sizes):
    """What the reference reads of a mesh: axis names and a devices array."""
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values())))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS + ["qwen2-1.5b:int8"])
def test_cache_specs_match_the_reference(arch, mesh):
    """Every cache leaf's spec, at a batch of 32 over 16 slots and a batch
    of 1 over 256 (the split-K long-context layouts)."""
    name, _, kv = arch.partition(":")
    jcfg, tcfg = jax_configs.get_smoke(name), torch_configs.get_smoke(name)
    if kv:
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv)
        tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv)
    jb, tb = jax_bundle_for(jcfg), bundle_for(tcfg)
    sizes = MESHES[mesh]
    jaxes = jax_sh.Axes.for_mesh(types.SimpleNamespace(
        axis_names=tuple(sizes)))
    taxes = sharding.Axes.for_mesh(sizes)
    assert (taxes.data, taxes.model) == (jaxes.data, jaxes.model)
    for batch, slots in ((32, 16), (1, 256)):
        jcache = jax.eval_shape(lambda: jb.init_cache(batch, slots))
        want = _ref_leaves(jax_sh.cache_pspecs(jb, jcache, jaxes,
                                               _fake_mesh(sizes)))
        shapes = {p: leaf.shape for p, leaf in _ref_leaves(jcache).items()}
        tcache = tb.init_cache(batch, slots, "meta")
        got = dict(sharding.spec_items(
            sharding.cache_pspecs(tb, tcache, taxes, sizes)))
        assert got.keys() == want.keys()
        for path, spec in got.items():
            assert spec == _full(want[path], len(shapes[path])), \
                (path, batch, slots)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_input_specs_shard_as_the_reference(shape, mesh):
    sizes = MESHES[mesh]
    jaxes = jax_sh.Axes.for_mesh(types.SimpleNamespace(
        axis_names=tuple(sizes)))
    taxes = sharding.Axes.for_mesh(sizes)
    dsize = int(np.prod([sizes[a] for a in jaxes.data]))
    for arch in ("phi-3-vision-4.2b", "seamless-m4t-large-v2",
                 "rwkv6-3b"):
        jspec = jax_configs.input_specs(arch, shape)
        tspec = torch_configs.input_specs(arch, shape)
        if jspec is None:
            assert tspec is None
            continue
        want = jax_sh.input_pspecs(jspec.inputs, jaxes, dsize)
        got = sharding.input_pspecs(tspec.inputs, taxes, dsize)
        assert got.keys() == want.keys()
        for k, spec in got.items():
            assert spec == _full(want[k], tspec.inputs[k].dim()), (arch, k)
    assert sharding.batch_pspec(taxes, 3) == _full(
        jax_sh.batch_pspec(jaxes, 3), 3)


def test_placements_on_a_one_rank_gloo_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = mesh_mod.make_host_mesh(1, "cpu")
        assert mesh_mod.describe(mesh) == \
            "mesh {'data': 1, 'model': 1} (1 devices)"
        assert sharding.mesh_sizes(mesh) == {"data": 1, "model": 1}
        assert sharding.Axes.for_mesh(mesh) == sharding.Axes()
        assert sharding.placements(mesh, ("data", None)) == \
            [Shard(0), Replicate()]
        assert sharding.placements(mesh, (None, "model")) == \
            [Replicate(), Shard(1)]
        assert sharding.placements(mesh, (("data", "model"), None)) == \
            [Shard(0), Shard(0)]
        assert sharding.placements(mesh, (None, None)) == \
            [Replicate(), Replicate()]
        with pytest.raises(ValueError, match="shards two"):
            sharding.placements(mesh, ("data", "data"))
        # A parameter laid out by its rule reads back whole.
        tb = bundle_for(torch_configs.get_smoke("llama3.2-1b"))
        spec = dict(sharding.spec_items(sharding.param_pspecs(
            tb, sharding.Axes(), 1)))["layers/0/attn/wq"]
        assert spec == (None, "model")
        w = torch.arange(12.0).view(3, 4)
        dt = distribute_tensor(w, mesh, sharding.placements(mesh, spec))
        assert torch.equal(dt.full_tensor(), w)
        mesh2 = mesh_mod.make_mesh((1,), ("data",), "cpu")
        assert mesh_mod.describe(mesh2) == "mesh {'data': 1} (1 devices)"
    finally:
        dist.destroy_process_group()


def test_meshes_without_a_counterpart_say_so():
    with pytest.raises(NotImplementedError, match="pod"):
        mesh_mod.make_production_mesh(multi_pod=True)
    with pytest.raises(NotImplementedError, match="ambient"):
        mesh_mod.activate(None)
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_host_mesh(1, "cpu")
    assert mesh_mod.backend_for("cpu") == "gloo"
    assert mesh_mod.backend_for(torch.device("cuda", 0)) == "nccl"
    with pytest.raises(ValueError):
        mesh_mod.backend_for("meta")


@pytest.mark.parametrize("kind", ["all-gather", "reduce-scatter",
                                  "all-reduce", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("group", [1, 2, 4, 8, 16])
def test_ring_model_matches_the_reference(kind, group):
    assert collectives._wire(kind, 8192, group) == \
        jax_coll._wire(kind, 8192, group)


def test_ring_model_numbers_and_summary():
    """`tests/test_distributed.py::test_collectives_ring_model`'s two ops,
    and the summary of both against the reference's."""
    ag = collectives.op("all-gather", "f32", (16, 128), 16 * 128 * 4, 4)
    assert np.isclose(ag.wire_bytes, 16 * 128 * 4 * 3 / 4)
    ar = collectives.op("all-reduce", "bf16", (64,), 64 * 2, 8)
    assert np.isclose(ar.wire_bytes, 2 * 64 * 2 * 7 / 8)
    want = jax_coll.summarize([
        jax_coll.CollectiveOp(o.kind, o.dtype, o.shape, o.payload_bytes,
                              o.group_size, o.wire_bytes) for o in (ag, ar)])
    assert collectives.summarize([ag, ar]) == want
