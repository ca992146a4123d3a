"""Serving driver of the port: the paper's loop (Fig. 2) over the real
PyTorch engine.

Mode:
  --mode engine    Camel drives the PyTorch `InferenceEngine` (the arch's
                   smoke config, seeded random weights): each arm's batch
                   and frequency change an actual batched inference call,
                   and the controller's summary is printed as JSON.

Options:
  --sensor SPEC    power source of every pull (`repro_torch.obs.make_sensor`):
                   `simulated` (default — the Jetson Orin analytical board
                   model, bit-identical to not sensing), `nvml` (the
                   card's measured board power through NVML), `sysfs`,
                   `replay:<path>`, `record:<path>` or `fallback:a,b,...`.
                   The engine mode meters each pull with it.
  --scheduler S    `static` (one fixed batch a pull) or `continuous`
                   (slot-level admission over Poisson arrivals with ragged
                   output lengths: the batch arm becomes the slot pool's
                   width).
  --metrics-out PATH   open a `repro_torch.obs` session for the run: the
                   controller's rounds, pulls and commit and the engine's
                   prefill/decode/request spans go to a JSONL trace with
                   the metrics snapshot appended; summarize it with
                   `tools/trace_report.py PATH`.

Runs on CUDA unless `--device cpu` is given.  The reference's
search/validate/tpu/fleet modes and `--faults` are not ported yet.

Usage (from the repository root; `--arch` is qwen2-1.5b (the default, as
in the reference), qwen2.5-3b, llama3.2-1b, smollm-360m, starcoder2-7b,
gemma2-27b, phi-3-vision-4.2b, mixtral-8x22b, olmoe-1b-7b, rwkv6-3b or
recurrentgemma-9b; the engine serves the arch's smoke config):
    PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
        --rounds 8
    PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
        --arch qwen2.5-3b --sensor nvml --rounds 8
    PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
        --scheduler continuous --sensor nvml --rounds 8
    PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
        --arch rwkv6-3b --rounds 8 --metrics-out trace.jsonl
"""

from __future__ import annotations

import argparse
import contextlib
import json

from repro_torch import obs
from repro_torch.core import baselines, controller, cost
from repro_torch.platform import make_env, make_space


def engine_mode(arch: str, rounds: int, alpha: float, seed: int,
                sensor: str = "simulated", decode_impl: str = "fused",
                scheduler: str = "static", device=None) -> dict:
    """Reference the cost model at the (max f, max b) corner, then run
    `rounds` rounds of CamelTS against the engine environment.  `sensor`
    meters every pull (the default "simulated" sensor reads the same
    board model the unmetered path evaluates, bit-identically);
    `scheduler` picks the serving discipline per pull."""
    name = f"engine/{arch}"
    env = make_env(name, seed=seed, prompt_len=16, max_new_tokens=8,
                   sensor=sensor, decode_impl=decode_impl,
                   scheduler=scheduler, device=device)
    space = make_space(name)
    cm = cost.CostModel(alpha=alpha)
    e0, l0 = env.pull(space.values(space.corner()), 0)
    cm = cm.with_reference(e0, l0)
    policy = baselines.make_policy("camel", prior_mu=1.0, prior_sigma=0.1)
    ctrl = controller.Controller(space, policy, cm, seed=seed)
    res = ctrl.run(env, rounds)
    return res.summary()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["engine"], default="engine")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--rounds", type=int, default=49)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", default="static",
                    choices=["static", "continuous"],
                    help="engine mode serving discipline: static batches "
                         "or continuous (slot-level) batching")
    ap.add_argument("--decode-impl", default="fused",
                    choices=["fused", "loop"],
                    help="fused (device token buffer, one host copy per "
                         "generate) or loop (a host copy per token)")
    ap.add_argument("--sensor", default="simulated",
                    help="power source: simulated | sysfs | nvml | "
                         "replay:<path> | record:<path> | fallback:a,b "
                         "(the engine mode meters every pull)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the run's JSONL event trace + metrics "
                         "snapshot here (summarize with "
                         "tools/trace_report.py)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    args = ap.parse_args()
    session = obs.observing(args.metrics_out) if args.metrics_out \
        else contextlib.nullcontext()
    with session:
        out = engine_mode(args.arch, args.rounds, args.alpha, args.seed,
                          sensor=args.sensor, decode_impl=args.decode_impl,
                          scheduler=args.scheduler, device=args.device)
    print(json.dumps(out, indent=2, default=str))


if __name__ == "__main__":
    main()
