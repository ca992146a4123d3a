"""Data-parallel training of the port on the CPU: two gloo ranks through
`run_training` against the same training without a process group.

The ranks are spawned processes joined to one group through a file store
under the test's temporary directory (no TCP port for parallel workers to
contend for), joined with a timeout and killed past TIME_LIMIT_S.  Each
writes its losses, its parameters after STEPS steps and step 0's reduced
gradients to a file; the test holds the ranks to each other bit for bit
and to one process training on the whole global batch.
"""

from __future__ import annotations

import time

import pytest
import torch
import torch.multiprocessing as tmp

from repro_torch.launch import steps as steps_mod
from repro_torch.launch.train import run_training
from repro_torch.models.registry import bundle_for
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import tree as tree_mod
from repro_torch.training.data import DataConfig, SyntheticLM

ARCH = "smollm-360m"
WORLD, GLOBAL_BATCH, SEQ_LEN, STEPS = 2, 4, 16, 3
OVERRIDES = {"dtype": torch.float32}
#: Losses and step 0's gradients, and the parameters after STEPS steps,
#: against one process: max |err| / (1 + |ref|).
LOSS_GRAD_TOL, PARAM_TOL = 1e-5, 1e-4
TIME_LIMIT_S = 120.0


def _train(**kw):
    return run_training(ARCH, smoke=True, steps=STEPS,
                        global_batch=GLOBAL_BATCH, seq_len=SEQ_LEN,
                        device="cpu", log_every=STEPS, overrides=OVERRIDES,
                        return_state=True, **kw)


def _step0_grads(group=None, rank=0, world=1):
    """Step 0's gradients as AdamW receives them (averaged over `group`'s
    ranks where one is given), from this rank's rows of batch 0."""
    import dataclasses

    import repro_torch.configs as configs
    cfg = dataclasses.replace(configs.get_smoke(ARCH), **OVERRIDES)
    bundle = bundle_for(cfg)
    params = bundle.init_params(0, "cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ_LEN,
                                  global_batch=GLOBAL_BATCH, seed=0))
    seen = []

    def capture(grads):
        seen.append({p: g.clone() for p, g in
                     tree_mod.flatten_with_paths(grads)})
        return grads
    step = steps_mod.make_train_step(bundle, opt_mod.AdamWConfig(),
                                     compress_grads=capture, group=group)
    _, _, metrics = step(params, opt_mod.init(params),
                         data.host_shard(0, rank, world))
    # The loss the step returns holds no view of the all-reduce's buffer
    # (it would keep the buffer alive through the next step).
    assert metrics["loss"].untyped_storage().nbytes() == 4
    return seen[0]


def _rank_main(rank, store, out_dir):
    """One rank: the data-parallel run, step 0's reduced gradients and the
    refusal of an odd global batch, written to `out_dir/rank<r>.pt`."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_mod
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        out = _train()
        mesh = mesh_mod.make_host_mesh(1, "cpu")
        grads = _step0_grads(mesh.get_group("data"),
                             mesh.get_local_rank("data"), mesh.size(0))
        try:
            run_training(ARCH, smoke=True, steps=1,
                         global_batch=GLOBAL_BATCH + 1, seq_len=SEQ_LEN,
                         device="cpu", overrides=OVERRIDES)
            refused = ""
        except ValueError as e:
            refused = str(e)
        torch.save({"losses": out["losses"],
                    "params": dict(tree_mod.flatten_with_paths(
                        out["params"])),
                    "dp": out["data_parallel"], "grads": grads,
                    "refused": refused, "mesh": mesh_mod.describe(mesh)},
                   f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return float(((a - b).abs() / (1 + b.abs())).max())


def test_two_gloo_ranks_train_as_one_process(tmp_path):
    ctx = tmp.start_processes(_rank_main,
                              args=(str(tmp_path / "store"), str(tmp_path)),
                              nprocs=WORLD, join=False,
                              start_method="spawn")
    deadline = time.monotonic() + TIME_LIMIT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"the {WORLD} ranks did not finish in "
                            f"{TIME_LIMIT_S:g} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]

    # The ranks agree bit for bit.
    a, b = ranks
    assert a["losses"] == b["losses"]
    assert a["params"].keys() == b["params"].keys()
    for path, p in a["params"].items():
        assert torch.equal(p, b["params"][path]), path
    for path, g in a["grads"].items():
        assert torch.equal(g, b["grads"][path]), path
    n = sum(p.numel() for p in a["params"].values())
    assert a["dp"]["world"] == WORLD and [r["dp"]["rank"] for r in ranks] \
        == list(range(WORLD))
    # One all-reduce a step: every gradient and the loss, in fp32.
    assert a["dp"]["n_collectives"] == 1
    assert a["dp"]["payload_bytes"] == 4 * (n + 1)
    assert a["dp"]["wire_bytes_per_device"] == \
        2 * (WORLD - 1) / WORLD * 4 * (n + 1)
    assert a["mesh"] == "mesh {'data': 2, 'model': 1} (2 devices)"
    for r in ranks:
        assert "does not divide over 2" in r["refused"]

    # ... and train as one process on the whole global batch.
    ref = _train()
    assert "data_parallel" not in ref
    assert _rel(a["losses"], ref["losses"]) <= LOSS_GRAD_TOL
    ref_grads = _step0_grads()
    assert ref_grads.keys() == a["grads"].keys()
    for path, g in ref_grads.items():
        assert _rel(a["grads"][path], g) <= LOSS_GRAD_TOL, path
    for path, p in tree_mod.flatten_with_paths(ref["params"]):
        assert _rel(a["params"][path], p) <= PARAM_TOL, path
