"""The serving entry point of the port: the paper's full loop (Fig. 2) end
to end.

Every backend is built through the `repro_torch.platform` registry
(`make_env` / `make_space`), so each mode is: name an environment,
normalize the cost model at the reference corner, run the controller.

Modes:
  --mode search    Camel against grid, UCB1, epsilon-greedy, random or
                   windowed TS (--policy) over the Jetson AGX Orin
                   landscape of --model (paper Results 1); --k > 1 runs
                   the batched controller, K arms a round through the
                   landscape's batched pull, evaluated on --device.  The
                   default mode, as in the reference.
  --mode validate  event-driven serving of --requests requests at Camel's
                   optimum against the three corner configurations (paper
                   Results 2; `edp_vs_maxf_maxb` is the EDP reduction
                   against (max f, max b)).
  --mode engine    Camel drives the PyTorch `InferenceEngine` (the arch's
                   smoke config, seeded random weights): each arm's batch
                   and frequency change an actual batched inference call.
  --mode fleet     batched Camel over a --fleet-size device fleet behind
                   one shared arrival queue (fleet/<n>xjetson), K = fleet
                   size slots a round; --policy contextual learns
                   per-device cost offsets from obs.metadata["device"].
  --mode async-fleet  the same fleet without the round barrier: K arms in
                   flight through the completion-ordered dispatcher,
                   staleness-aware updates; --straggler S makes device 0
                   return results S x slower (its telemetry unchanged).
                   Adds the simulated wall clock and the staleness.
--rounds is the exact pull budget in every mode (a final round is
truncated to what remains).  The search, validate and fleet figures are
the modelled Jetson AGX Orin (`serving.energy`), not the card's.

Options:
  --sensor SPEC    power source (`repro_torch.obs.make_sensor`):
                   `simulated` (default — the Jetson Orin analytical board
                   model, bit-identical to not sensing), `nvml` (the
                   card's measured board power through NVML), `sysfs`,
                   `replay:<path>`, `record:<path>` or `fallback:a,b,...`.
                   The engine mode meters each pull with it; the other
                   modes meter the whole run with a non-simulated sensor
                   and report it under a `sensor` key.
  --scheduler S    engine mode: `static` (one fixed batch a pull) or
                   `continuous` (slot-level admission over Poisson
                   arrivals with ragged output lengths).
  --metrics-out PATH   open a `repro_torch.obs` session for the run: the
                   controller's rounds, pulls, updates and commit, the
                   dispatcher's submits and waves and the engine's spans
                   go to a JSONL trace with the metrics snapshot appended;
                   summarize it with `tools/trace_report.py PATH`.
  --faults SPEC    seeded fault injection (`repro_torch.faults.parse_faults`,
                   the reference's grammar, e.g.
                   ``pull_fail=0.2,crash=0@4,deadline=4,seed=1``): the fleet
                   modes run behind the fault-wrapping fleet env (crashed
                   and throttled devices, flaky pulls, dispatcher deadlines
                   and retries), the engine mode stamps request deadlines
                   and wraps its power sensor, and any run-level sensor
                   becomes flaky.  An empty or ``none`` spec is a no-op
                   (a bit-identical run); the output gains a `faults` key
                   otherwise.

Runs on CUDA unless `--device cpu` is given.  The reference's tpu mode is
not ported yet.

Usage (from the repository root):
    PYTHONPATH=src python -m repro_torch.launch.serve --model llama3.2-1b \
        --rounds 49
    PYTHONPATH=src python -m repro_torch.launch.serve --mode validate \
        --model qwen2.5-3b --requests 2500
    PYTHONPATH=src python -m repro_torch.launch.serve --mode fleet \
        --fleet-size 4 --policy contextual
    PYTHONPATH=src python -m repro_torch.launch.serve --mode async-fleet \
        --fleet-size 4 --straggler 4 --metrics-out trace.jsonl
    PYTHONPATH=src python -m repro_torch.launch.serve --mode engine \
        --arch qwen2.5-3b --sensor nvml --rounds 8
(`--arch` is qwen2-1.5b (the default, as in the reference), qwen2.5-3b,
llama3.2-1b, smollm-360m, starcoder2-7b, gemma2-27b, phi-3-vision-4.2b,
mixtral-8x22b, olmoe-1b-7b, rwkv6-3b or recurrentgemma-9b.)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math

from repro_torch import obs
from repro_torch.core import baselines, controller, cost, priors
from repro_torch.faults import parse_faults, wrap_env, wrap_sensor
from repro_torch.platform import make_env, make_space
from repro_torch.serving import energy as energy_mod
from repro_torch.serving import simulator as sim_mod
from repro_torch.serving.requests import ArrivalProcess


def _landscape_reference(env, space, alpha: float):
    """The cost model normalized at the (max f, max b) corner, and the
    noise-free landscape's optimal arm and cost."""
    cm = cost.CostModel(alpha=alpha)
    e_ref, l_ref = env.expected(space.values(space.corner()))
    cm = cm.with_reference(e_ref, l_ref)
    opt_arm, opt_cost = controller.landscape_optimal(space, env.expected, cm)
    return cm, opt_arm, opt_cost


def search_mode(model: str, rounds: int, alpha: float, seed: int,
                policy_name: str = "camel", k: int = 1, device=None) -> dict:
    """`rounds` is the pull budget, served in ceil(rounds / k) rounds of
    K concurrent evaluations, the final round truncated so exactly
    `rounds` pulls run.  `device` is where the landscape's batched pulls
    evaluate."""
    return search_run(model, rounds, alpha, seed, policy_name, k, device)[0]


def search_run(model: str, rounds: int, alpha: float, seed: int,
               policy_name: str = "camel", k: int = 1, device=None):
    """`search_mode`'s search: returns (summary, the controller's
    result)."""
    name = f"jetson/{model}/landscape"
    env = make_env(name, noise=0.03, seed=seed, device=device)
    space = make_space(name)
    cm, opt_arm, opt_cost = _landscape_reference(env, space, alpha)
    if policy_name == "camel":
        policy, _, _ = priors.jetson_camel_policy(model, space, alpha)
    else:
        policy = baselines.make_policy(policy_name)
    ctrl = controller.BatchController(space, policy, cm,
                                      optimal_cost=opt_cost, seed=seed, k=k)
    res = ctrl.run(env, max(1, math.ceil(rounds / k)), pull_budget=rounds)
    summary = res.summary()
    summary["optimal_knobs"] = space.values(opt_arm)
    summary["found_optimal"] = bool(res.best_arm == opt_arm)
    summary["k"] = k
    summary["n_rounds"] = res.n_rounds
    summary["n_pulls"] = len(res.records)
    return summary, res


def validate_mode(model: str, n_requests: int, alpha: float, seed: int,
                  device=None) -> dict:
    """Event-driven serving of `n_requests` at the landscape's optimum and
    the three corners (host code; `device` only builds the landscape)."""
    name = f"jetson/{model}/landscape"
    env = make_env(name, noise=0.0, device=device)
    space = make_space(name)
    cm, opt_arm, _ = _landscape_reference(env, space, alpha)
    board = energy_mod.JETSON_AGX_ORIN
    work = energy_mod.ORIN_WORKLOADS[model]
    configs = {
        "camel_optimal": space.values(opt_arm),
        "maxf_minb": space.values(space.corner(batch="min")),
        "maxf_maxb": space.values(space.corner()),
        "minf_maxb": space.values(space.corner(freq_mhz="min")),
    }
    out = {}
    for cname, knobs in configs.items():
        server = sim_mod.EventDrivenServer(
            board, work, ArrivalProcess(interval_s=1.0, seed=seed),
            n_requests, noise=0.02, seed=seed)
        res = server.run(sim_mod.fixed_config_tuner(knobs["freq_mhz"],
                                                    knobs["batch"]))
        s = res.summary()
        s["knobs"] = knobs
        s["cost"] = float(cm.cost(s["energy_per_req"], s["latency_per_req"]))
        out[cname] = s
    base = out["maxf_maxb"]["edp"]
    for cname in configs:
        out[cname]["edp_vs_maxf_maxb"] = 1.0 - out[cname]["edp"] / base
    return out


def engine_mode(arch: str, rounds: int, alpha: float, seed: int,
                sensor: str = "simulated", decode_impl: str = "fused",
                scheduler: str = "static", faults=None,
                device=None) -> dict:
    """Reference the cost model at the (max f, max b) corner, then run
    `rounds` rounds of CamelTS against the engine environment.  `sensor`
    meters every pull (the default "simulated" sensor reads the same
    board model the unmetered path evaluates, bit-identically);
    `scheduler` picks the serving discipline per pull; `faults` (a
    `FaultPlan`) wraps the sensor and cancels requests."""
    name = f"engine/{arch}"
    env = make_env(name, seed=seed, prompt_len=16, max_new_tokens=8,
                   sensor=sensor, decode_impl=decode_impl,
                   scheduler=scheduler, faults=faults, device=device)
    space = make_space(name)
    cm = cost.CostModel(alpha=alpha)
    e0, l0 = env.pull(space.values(space.corner()), 0)
    cm = cm.with_reference(e0, l0)
    policy = baselines.make_policy("camel", prior_mu=1.0, prior_sigma=0.1)
    ctrl = controller.Controller(space, policy, cm, seed=seed)
    res = ctrl.run(env, rounds)
    return res.summary()


def _fleet_policy(policy_name: str, model: str, space, alpha: float,
                  n_devices: int):
    """"camel" and "contextual" share the analytic Camel prior;
    "contextual" also learns per-device additive offsets from the device
    ids the fleet stamps on every observation."""
    if policy_name == "contextual":
        return priors.jetson_contextual_policy(model, space, n_devices,
                                               alpha)[0]
    if policy_name == "camel":
        return priors.jetson_camel_policy(model, space, alpha)[0]
    return baselines.make_policy(policy_name)


def _fleet_summary(res, space, opt_arm: int, n_devices: int, k: int,
                   policy_name: str) -> dict:
    out = res.summary()
    out["optimal_knobs"] = space.values(opt_arm)
    out["found_optimal"] = bool(res.best_arm == opt_arm)
    out["n_devices"] = n_devices
    out["k"] = k
    out["policy"] = policy_name
    return out


def fleet_run(model: str, rounds: int, alpha: float, seed: int,
              n_devices: int, k: int = 0, policy_name: str = "camel",
              straggler=None, faults=None, device=None):
    """The search of `fleet_mode` (``straggler=None``: the synchronous
    `BatchController`) or of `async_fleet_mode` (the `AsyncController`,
    device 0's results `straggler` x slower).  `faults` (a `FaultPlan`)
    wraps the run env only (`wrap_env`); the cost model's reference and
    the landscape's optimum stay fault-free.  Returns (summary, the
    controller's result)."""
    k = k if k > 0 else n_devices
    name = f"fleet/{n_devices}xjetson/{model}/landscape"
    env_kw = dict(noise=0.03, seed=seed, device=device)
    if straggler is not None:
        env_kw["dispatch_factors"] = (straggler,) + (1.0,) * (n_devices - 1)
    env = make_env(name, **env_kw)
    space = make_space(name)
    cm, opt_arm, opt_cost = _landscape_reference(env, space, alpha)
    policy = _fleet_policy(policy_name, model, space, alpha, n_devices)
    ctrl_cls = controller.BatchController if straggler is None \
        else controller.AsyncController
    ctrl = ctrl_cls(space, policy, cm, optimal_cost=opt_cost, seed=seed,
                    k=k)
    run_env = env if faults is None else wrap_env(env, faults)
    res = ctrl.run(run_env, max(1, math.ceil(rounds / k)),
                   pull_budget=rounds)
    out = _fleet_summary(res, space, opt_arm, n_devices, k, policy_name)
    if straggler is None:
        out["n_rounds"] = res.n_rounds
        out["n_pulls"] = len(res.records)
        return out, res
    staleness = [r.obs.metadata["staleness"] for r in res.records]
    out["straggler"] = straggler
    out["n_waves"] = res.n_rounds
    out["n_pulls"] = len(res.records)
    out["wall_clock_sim_s"] = float(
        res.records[-1].obs.metadata["finished_at"]) if res.records else 0.0
    out["mean_staleness"] = (float(sum(staleness) / len(staleness))
                             if staleness else 0.0)
    out["max_staleness"] = int(max(staleness)) if staleness else 0
    return out, res


def fleet_mode(model: str, rounds: int, alpha: float, seed: int,
               n_devices: int, k: int = 0, policy_name: str = "camel",
               faults=None, device=None) -> dict:
    """Batched Camel search over an N-device fleet: K slots a round
    (default: one per device) across the fleet's shared arrival queue,
    one delayed posterior update a round."""
    return fleet_run(model, rounds, alpha, seed, n_devices, k, policy_name,
                     faults=faults, device=device)[0]


def async_fleet_mode(model: str, rounds: int, alpha: float, seed: int,
                     n_devices: int, k: int = 0, straggler: float = 1.0,
                     policy_name: str = "camel", faults=None,
                     device=None) -> dict:
    """Asynchronous Camel search over an N-device fleet: K arms in flight
    through the completion-ordered dispatcher (default K = fleet size),
    staleness-aware updates a completion; `straggler` slows device 0's
    completions without changing its telemetry."""
    return fleet_run(model, rounds, alpha, seed, n_devices, k, policy_name,
                     straggler=straggler, faults=faults, device=device)[0]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["search", "validate", "engine",
                                       "fleet", "async-fleet"],
                    default="search")
    ap.add_argument("--model", default="llama3.2-1b",
                    help="Jetson Orin workload of the search, validate "
                         "and fleet modes (llama3.2-1b or qwen2.5-3b)")
    ap.add_argument("--arch", default="qwen2-1.5b",
                    help="engine mode: the model the engine serves")
    ap.add_argument("--rounds", type=int, default=49)
    ap.add_argument("--requests", type=int, default=2500)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k", type=int, default=0,
                    help="arms evaluated concurrently a round (batched "
                         "Thompson sampling); 0 = auto (1, or the fleet "
                         "size in the fleet modes)")
    ap.add_argument("--fleet-size", type=int, default=4)
    ap.add_argument("--policy", default="camel",
                    choices=sorted(baselines.POLICIES),
                    help="search policy; 'contextual' (fleet modes only) "
                         "learns per-device cost offsets")
    ap.add_argument("--straggler", type=float, default=1.0,
                    help="async-fleet: device 0 returns results this many "
                         "times slower (telemetry unchanged; 1.0 = "
                         "homogeneous)")
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
                         "(engine mode meters every pull; other modes "
                         "meter the whole run for non-simulated sensors)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the run's JSONL event trace + metrics "
                         "snapshot here (summarize with "
                         "tools/trace_report.py)")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="seeded fault injection spec, e.g. "
                         "'pull_fail=0.2,crash=0@4,deadline=4,seed=1' "
                         "(the reference's grammar, docs/RESILIENCE.md); "
                         "empty or 'none' disables injection")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    args = ap.parse_args()

    plan = parse_faults(args.faults) if args.faults else None
    if plan is not None and plan.is_zero:
        plan = None      # an explicit no-op spec keeps the bit-identical run
    if args.policy == "contextual" and args.mode not in ("fleet",
                                                         "async-fleet"):
        ap.error("--policy contextual needs device context; use "
                 "--mode fleet or --mode async-fleet")

    def dispatch() -> dict:
        if args.mode == "search":
            return search_mode(args.model, args.rounds, args.alpha,
                               args.seed, policy_name=args.policy,
                               k=max(1, args.k), device=args.device)
        if args.mode == "validate":
            return validate_mode(args.model, args.requests, args.alpha,
                                 args.seed, device=args.device)
        if args.mode == "engine":
            return engine_mode(args.arch, args.rounds, args.alpha,
                               args.seed, sensor=args.sensor,
                               decode_impl=args.decode_impl,
                               scheduler=args.scheduler, faults=plan,
                               device=args.device)
        if args.mode == "fleet":
            return fleet_mode(args.model, args.rounds, args.alpha,
                              args.seed, args.fleet_size, k=args.k,
                              policy_name=args.policy, faults=plan,
                              device=args.device)
        return async_fleet_mode(args.model, args.rounds, args.alpha,
                                args.seed, args.fleet_size, k=args.k,
                                straggler=args.straggler,
                                policy_name=args.policy, faults=plan,
                                device=args.device)

    session = obs.observing(args.metrics_out) if args.metrics_out \
        else contextlib.nullcontext()
    with session:
        if args.sensor != "simulated" and args.mode != "engine":
            # The engine mode meters each pull; every other backend is
            # simulation-clocked, so the sensor meters the whole run.
            sensor = obs.make_sensor(args.sensor)
            if plan is not None:
                sensor = wrap_sensor(sensor, plan)
            meter = obs.EnergyMeter(sensor)
            try:
                with meter.measure() as m:
                    out = dispatch()
            finally:
                sensor.close()
            obs.emit("sensor.run", **m.summary())
            out["sensor"] = m.summary()
        else:
            out = dispatch()
    if plan is not None:
        out["faults"] = args.faults
    print(json.dumps(out, indent=2, default=str))


if __name__ == "__main__":
    main()
