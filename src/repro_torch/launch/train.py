"""Training driver of the port, the counterpart of `repro.launch.train`.

End-to-end: config -> params and AdamW state on one device -> data
pipeline -> train step -> checkpoint manager (+ restart) -> straggler
watchdog.  It runs on the card unless told otherwise (`device="cpu"`, as
the tests run it) and trains the LM families (the transformer, rwkv6,
recurrentgemma); the encoder-decoder trains through `make_train_step`, as
in the reference.

Data parallelism: under an initialized process group of W ranks (one card
each, NCCL; or gloo on the CPU), rank r trains on rows [r B / W,
(r + 1) B / W) of each global batch, over the data axis of a ("data",
"model") mesh of W x 1 (`launch/mesh.py`); the train step averages the
gradients over the ranks before its update (`launch/steps.py`), so every
rank holds the same parameters, and rank 0 alone prints and writes
checkpoints.  Tensor parallelism over a "model" axis (`model_parallel`
> 1) has no counterpart on a one-card machine (ROADMAP.md item 9c).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 8 --global-batch 8 --seq-len 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --device cpu --steps 20 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
        --steps 8 --global-batch 8 --seq-len 512 --remat full
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch llama3.2-1b --steps 8 --global-batch 32 --seq-len 512
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path
from typing import Any, Dict, Optional

import repro_torch.configs as configs_mod
from repro_torch._device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models.registry import bundle_for
from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.elastic import StepTimer, StragglerWatchdog
from repro_torch.training.optimizer import AdamWConfig


def run_training(arch: str, *, smoke: bool = True, steps: int = 20,
                 global_batch: int = 8, seq_len: int = 64,
                 ckpt_dir: str = "", ckpt_every: int = 10,
                 model_parallel: int = 1, lr: float = 3e-4,
                 seed: int = 0, log_every: int = 5,
                 fail_at_step: int = -1, device=None, ckpt_keep: int = 3,
                 overrides: Optional[Dict[str, Any]] = None,
                 return_state: bool = False) -> dict:
    """Trains `arch` (its smoke config, or the full one) and returns the
    reference's summary — final_loss, first_loss, steps_run, start_step,
    flagged_steps — plus `losses` and `step_s` (each step's seconds, the
    step ending in its loss's one host sync), and under a process group
    `data_parallel` (world, rank, the all-reduce's bytes a step).  Each
    loss is the global batch's.  `fail_at_step` injects a crash (tests the
    checkpoint/restart path).  `overrides` replaces config fields (e.g.
    {"remat": "full"}, {"n_layers": 4}); `ckpt_keep` checkpoints are kept;
    `return_state` adds the final `params` and `opt_state`."""
    cfg = (configs_mod.get_smoke(arch) if smoke else configs_mod.get(arch))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    bundle = bundle_for(cfg)
    if bundle.family == "encdec":
        raise NotImplementedError(
            "train.py drives LM-family archs; seamless trains through "
            "examples/train_encdec semantics in tests")
    if model_parallel != 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: the port trains data-parallel "
            "only; tensor parallelism over a 'model' axis has no counterpart "
            "on a one-card machine (ROADMAP.md Queue 1 item 9c)")
    dev = resolve_device(device)
    group, rank, world = _data_axis(dev)
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"{world} data-parallel ranks")
    lead = rank == 0

    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(10, steps),
                          total_steps=max(steps, 1))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=seq_len,
                                  global_batch=global_batch, seed=seed))
    step_fn = steps_mod.make_train_step(bundle, opt_cfg, group=group)

    manager = None
    if ckpt_dir and lead:
        manager = ckpt_mod.CheckpointManager(Path(ckpt_dir),
                                             every_steps=ckpt_every,
                                             keep=ckpt_keep)
        manager.install_signal_handler()

    def init_state():
        params = bundle.init_params(seed, dev)
        return params, opt_mod.init(params)

    try:
        start_step = 0
        if ckpt_dir:
            abstract = bundle.abstract_params()
            template = (abstract, opt_mod.init(abstract))
            got = ckpt_mod.restore_latest(ckpt_dir, template, dev)
            if got is not None:
                start_step, (params, opt_state), extra = got
                if lead:
                    print(f"[train] resumed from step {start_step}")
            else:
                params, opt_state = init_state()
        else:
            params, opt_state = init_state()

        watchdog = StragglerWatchdog()
        losses, step_s = [], []
        for step in range(start_step, steps):
            if step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = {k: v.to(dev) for k, v in
                     data.host_shard(step, rank, world).items()}
            with StepTimer() as t:
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                loss = float(metrics["loss"])
            losses.append(loss)
            step_s.append(t.elapsed)
            straggling = watchdog.observe(step, t.elapsed)
            if straggling and watchdog.should_escalate and lead:
                print(f"[train] step {step}: persistent straggler — "
                      "escalate to elastic re-shard (training/elastic.py)")
            if step % log_every == 0 and lead:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({t.elapsed*1e3:.0f} ms)")
            if manager is not None:
                manager.maybe_save(step + 1, (params, opt_state),
                                   extra={"data_step": step + 1})

        if manager is not None:
            ckpt_mod.save(ckpt_dir, steps, (params, opt_state),
                          extra={"data_step": steps}, keep=ckpt_keep)

        out = {"final_loss": losses[-1] if losses else float("nan"),
               "first_loss": losses[0] if losses else float("nan"),
               "steps_run": len(losses), "start_step": start_step,
               "flagged_steps": list(watchdog.flagged_steps),
               "losses": losses, "step_s": step_s}
        if group is not None:
            out["data_parallel"] = {"world": world, "rank": rank,
                                    **(step_fn.comm or {})}
        if return_state:
            out.update(params=params, opt_state=opt_state)
        return out
    finally:
        # SIGTERM goes back to what it was: the flag it sets belongs to
        # this run's manager alone.
        if manager is not None:
            manager.remove_signal_handler()


def _data_axis(dev):
    """(data-axis process group, rank, world) of an initialized process
    group, over a (world, 1) ("data", "model") mesh on `dev`'s type; (None,
    0, 1) without one.  Raises where the group's backend is not the one
    `dev` takes (`mesh.backend_for`)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return None, 0, 1
    want = mesh_mod.backend_for(dev)
    have = str(dist.get_backend())
    if want not in have.split(",") and f"{dev.type}:{want}" not in have:
        raise RuntimeError(f"process group backend {have!r} for tensors on "
                           f"{dev}: the port trains there over {want!r}")
    mesh = mesh_mod.make_host_mesh(1, dev.type)
    return (mesh.get_group("data"), mesh.get_local_rank("data"),
            mesh.size(0))


def _init_from_env(device):
    """Under `torchrun` (WORLD_SIZE in the environment): the process group
    over env://, NCCL on the card (this rank's LOCAL_RANK card) or gloo on
    the CPU, and the device to train on."""
    import torch
    import torch.distributed as dist
    dev = resolve_device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group(mesh_mod.backend_for(dev), init_method="env://")
    return dev


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--remat", choices=("none", "dots", "full"),
                    default=None, help="the config's remat policy "
                    "(default: the config's own, 'none')")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    device = _init_from_env(args.device)
    try:
        out = run_training(args.arch, smoke=args.smoke, steps=args.steps,
                           global_batch=args.global_batch,
                           seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every,
                           model_parallel=args.model_parallel, lr=args.lr,
                           fail_at_step=args.fail_at_step, device=device,
                           overrides=None if args.remat is None
                           else {"remat": args.remat})
    finally:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    if out.get("data_parallel", {}).get("rank", 0) == 0:
        print("[train] done:", out)


if __name__ == "__main__":
    main()
