"""Serving driver of the port: the paper's loop (Fig. 2) over the real
PyTorch engine.

Mode:
  --mode engine    Camel drives the PyTorch `InferenceEngine` (the arch's
                   smoke config, seeded random weights): each arm's batch
                   and frequency change an actual batched inference call,
                   and the controller's summary is printed as JSON.

Runs on CUDA unless `--device cpu` is given.  Energy is the Jetson Orin
analytical board model applied to measured wall time (modelled, not
measured on the card).  The reference's search/validate/tpu/fleet modes
are not ported yet.

Usage (from the repository root; `--arch` is llama3.2-1b or olmoe-1b-7b):
    PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
        --arch llama3.2-1b --rounds 8
    PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
        --arch olmoe-1b-7b --rounds 8
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core import baselines, controller, cost
from repro_torch.platform import make_env, make_space


def engine_mode(arch: str, rounds: int, alpha: float, seed: int,
                decode_impl: str = "fused", device=None) -> dict:
    """Reference the cost model at the (max f, max b) corner, then run
    `rounds` rounds of CamelTS against the engine environment."""
    name = f"engine/{arch}"
    env = make_env(name, seed=seed, prompt_len=16, max_new_tokens=8,
                   decode_impl=decode_impl, device=device)
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
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--rounds", type=int, default=49)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode-impl", default="fused",
                    choices=["fused", "loop"],
                    help="fused (device token buffer, one host copy per "
                         "generate) or loop (a host copy per token)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    args = ap.parse_args()
    out = engine_mode(args.arch, args.rounds, args.alpha, args.seed,
                      decode_impl=args.decode_impl, device=args.device)
    print(json.dumps(out, indent=2, default=str))


if __name__ == "__main__":
    main()
