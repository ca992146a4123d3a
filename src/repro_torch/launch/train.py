"""Training driver of the port, the counterpart of `repro.launch.train`.

End-to-end: config -> params and AdamW state on one device -> data
pipeline -> train step -> checkpoint manager (+ restart) -> straggler
watchdog.  It runs on the card unless told otherwise (`device="cpu"`, as
the tests run it) and trains the LM families (the transformer, rwkv6,
recurrentgemma); the encoder-decoder trains through `make_train_step`, as
in the reference.  The loop has no mesh: the reference's sharded launcher
(`distributed/*`, `launch/mesh.py`) is ROADMAP.md Queue 1 item 9c.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 8 --global-batch 8 --seq-len 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --device cpu --steps 20 --ckpt-dir /tmp/ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \\
        --steps 8 --global-batch 8 --seq-len 512 --remat full
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Any, Dict, Optional

import repro_torch.configs as configs_mod
from repro_torch._device import resolve_device
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
                 overrides: Optional[Dict[str, Any]] = None) -> dict:
    """Trains `arch` (its smoke config, or the full one) and returns the
    reference's summary — final_loss, first_loss, steps_run, start_step,
    flagged_steps — plus `losses` and `step_s` (each step's seconds, the
    step ending in its loss's one host sync).  `fail_at_step` injects a
    crash (tests the checkpoint/restart path).  `overrides` replaces
    config fields (e.g. {"remat": "full"}, {"n_layers": 4});
    `ckpt_keep` checkpoints are kept."""
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
            f"model_parallel={model_parallel}: the port trains on one card; "
            "the device mesh and sharding (distributed/*, launch/mesh.py) "
            "are ROADMAP.md Queue 1 item 9c")
    dev = resolve_device(device)

    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(10, steps),
                          total_steps=max(steps, 1))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=seq_len,
                                  global_batch=global_batch, seed=seed))
    step_fn = steps_mod.make_train_step(bundle, opt_cfg)

    manager = None
    if ckpt_dir:
        manager = ckpt_mod.CheckpointManager(Path(ckpt_dir),
                                             every_steps=ckpt_every,
                                             keep=ckpt_keep)
        manager.install_signal_handler()

    def init_state():
        params = bundle.init_params(seed, dev)
        return params, opt_mod.init(params)

    try:
        start_step = 0
        if manager is not None:
            abstract = bundle.abstract_params()
            template = (abstract, opt_mod.init(abstract))
            got = ckpt_mod.restore_latest(ckpt_dir, template, dev)
            if got is not None:
                start_step, (params, opt_state), extra = got
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
            batch = {k: v.to(dev) for k, v in data.batch(step).items()}
            with StepTimer() as t:
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
                loss = float(metrics["loss"])
            losses.append(loss)
            step_s.append(t.elapsed)
            straggling = watchdog.observe(step, t.elapsed)
            if straggling and watchdog.should_escalate:
                print(f"[train] step {step}: persistent straggler — "
                      "escalate to elastic re-shard (training/elastic.py)")
            if step % log_every == 0:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({t.elapsed*1e3:.0f} ms)")
            if manager is not None:
                manager.maybe_save(step + 1, (params, opt_state),
                                   extra={"data_step": step + 1})

        if manager is not None:
            ckpt_mod.save(ckpt_dir, steps, (params, opt_state),
                          extra={"data_step": steps}, keep=ckpt_keep)

        return {"final_loss": losses[-1] if losses else float("nan"),
                "first_loss": losses[0] if losses else float("nan"),
                "steps_run": len(losses), "start_step": start_step,
                "flagged_steps": list(watchdog.flagged_steps),
                "losses": losses, "step_s": step_s}
    finally:
        # SIGTERM goes back to what it was: the flag it sets belongs to
        # this run's manager alone.
        if manager is not None:
            manager.remove_signal_handler()


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
    out = run_training(args.arch, smoke=args.smoke, steps=args.steps,
                       global_batch=args.global_batch, seq_len=args.seq_len,
                       ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       model_parallel=args.model_parallel, lr=args.lr,
                       fail_at_step=args.fail_at_step, device=args.device,
                       overrides=None if args.remat is None
                       else {"remat": args.remat})
    print("[train] done:", out)


if __name__ == "__main__":
    main()
