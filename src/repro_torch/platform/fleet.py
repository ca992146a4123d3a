"""Fleet platform of the port (a copy of `repro.platform.fleet`): N
heterogeneous devices behind one shared arrival queue.

The multi-device edge serving setting (Network Edge Inference for LLMs,
arXiv:2604.22906): a fleet of N devices drains one shared request stream,
so each device sees 1/N of the fleet arrival rate, and a K-wide
BatchController round dispatches its K slots across the devices
round-robin — the fleet is the natural consumer of batched Thompson
sampling, because K concurrent pulls really do run concurrently on
different hardware.

Per-device heterogeneity (the device-to-device energy variance
characterized in arXiv:2511.11624) is modeled as persistent multiplicative
offsets drawn once per device: `speed_jitter` scales a device's service
time (and therefore its energy, E = P·t/b), `power_jitter` scales its
power draw (energy only).  Offsets are lognormal around 1 with the given
sigma, deterministic in the fleet seed.  Every observation a fleet
produces — scalar `pull`, vectorized `pull_many`, and the asynchronous
`pull_on` path alike — stamps its serving device in
``metadata["device"]``; that id is the context variable the
device-contextual sampler (`bandit.ContextualTS`, ``--policy
contextual``) consumes to keep persistent offsets from biasing the
shared posterior's commit.

Construct by registry name — ``fleet/<n>x<platform>/<model>/<scenario>``,
e.g. ``make_env("fleet/4xjetson/llama3.2-1b/landscape")`` — or directly
via `make_fleet`.  `merge_observations` folds one round's per-device
observations into fleet totals (requests, joules, tokens and power add up;
latency is request-weighted) for fleet-level summaries and conservation
checks.

Observation-delay semantics: dispatch is synchronous or asynchronous
--------------------------------------------------------------------
`pull_many` is the *synchronous* path: a K-wide round is a barrier —
every slot's observation is returned together, so the round's wall-clock
is the slowest device's busy time (`barrier_walltimes` reconstructs that
timeline for a recorded run).  The *asynchronous* path goes through
`platform.base.AsyncDispatcher` via two per-device hooks defined here:
`pull_on(d, knobs, logical_round)` evaluates one slot on one device
(using the device's vectorized hook when it declares round-independence,
so both paths produce identical numbers), and `pull_duration(d)` is the
simulated wall-clock one pull occupies device d — its measurement horizon
times `dispatch_factors[d]`.  `dispatch_factors` model *stragglers*:
a device that is slow to return results (contention, thermal throttling,
restarts) without its serving telemetry changing — the observation is the
same, it just arrives late, and late observations carry staleness the
bandit discounts for (`bandit.update_stale`).

A device whose `pull_on` raises `PullFault` is re-dispatched, quarantined
and ultimately censored by the dispatcher; an infinite `dispatch_factors`
entry models a *hung* device, survivable only with dispatcher deadlines
armed (`AsyncDispatcher(deadline_s=...)`).  `repro_torch.faults` wraps a
fleet in a seeded fault plan (`FaultyFleet`: crashes, throttles, flaky
pulls, and the dispatcher's deadlines and retries from the same plan).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.platform.base import BaseEnvironment, measurement_horizon
from repro_torch.platform.telemetry import Observation


def merge_observations(obs_list: Sequence[Observation]) -> Observation:
    """Fold per-device observations of one fleet round into fleet totals.

    Conservation contract (tested): merged tokens / joules / power are the
    sums of the per-device values; `batch` is the total requests served;
    per-request fields (energy, latency, queue_wait, backlog) are
    request-weighted means; `batch_time` is the wall-clock of the
    concurrent round = the slowest device's batch time.
    """
    if not obs_list:
        raise ValueError("merge_observations needs at least one observation")
    obs_list = [Observation.of(o) for o in obs_list]
    # Legacy tuple-coerced observations carry batch=0 -> weight equally.
    reqs = np.array([max(o.batch, 1) for o in obs_list], float)
    total = reqs.sum()
    w = reqs / total

    def wmean(field):
        return float(np.dot(w, [getattr(o, field) for o in obs_list]))

    return Observation(
        energy=float(np.dot(reqs, [o.energy for o in obs_list])) / total,
        latency=wmean("latency"),
        batch_time=float(max(o.batch_time for o in obs_list)),
        queue_wait=wmean("queue_wait"),
        backlog=wmean("backlog"),
        power=float(sum(o.power for o in obs_list)),
        batch=int(total),
        tokens=int(sum(o.tokens for o in obs_list)),
        metadata={"backend": "fleet", "n_merged": len(obs_list),
                  "devices": tuple(o.metadata.get("device", -1)
                                   for o in obs_list)})


class FleetEnv(BaseEnvironment):
    """Composite Environment over N per-device environments.

    Dispatch is stateless in `round_index` (the registry contract: slot i
    is logical round ``round_index + i``): slot i of a K-wide round goes
    to device ``(i + round_index // K) mod N``, i.e. the slot->device map
    rotates by one device per controller round.  The rotation matters: a
    frequently re-selected arm tends to reappear at the same slot
    position, and a fixed map would pin it to one device — its empirical
    mean would then estimate that device's cost, not the fleet's, biasing
    the commit under persistent device offsets.  Replaying a call with
    the same `round_index` reproduces the same dispatch, and scalar
    `pull(knobs, t)` is the K=1 case of the same rule (device ``t mod
    N``).  Round-sensitive device backends (e.g. the events scenario's
    trace seeds) receive each slot's global logical round; devices with
    their own vectorized `pull_many` get their slot group in one call, so
    a fleet of vectorized landscapes costs N jitted calls per round, not
    K scalar pulls.

    `speed_factors[d]` multiplies device d's latency and energy;
    `power_factors[d]` multiplies its energy only (see module docstring).
    `dispatch_factors[d]` multiplies how long device d takes to *return*
    a pull on the asynchronous path (straggler modeling) without touching
    its observed telemetry.
    """

    def __init__(self, devices: Sequence, speed_factors: Sequence[float],
                 power_factors: Sequence[float], name: str = "fleet",
                 dispatch_factors: Optional[Sequence[float]] = None):
        if not devices:
            raise ValueError("a fleet needs at least one device")
        if not (len(devices) == len(speed_factors) == len(power_factors)):
            raise ValueError("per-device factor lengths must match devices")
        if dispatch_factors is None:
            dispatch_factors = [1.0] * len(devices)
        if len(dispatch_factors) != len(devices):
            raise ValueError("per-device factor lengths must match devices")
        self.devices = list(devices)
        self.speed_factors = tuple(float(s) for s in speed_factors)
        self.power_factors = tuple(float(p) for p in power_factors)
        self.dispatch_factors = tuple(float(f) for f in dispatch_factors)
        self.name = name
        self.platform = getattr(self.devices[0], "platform", None)

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def _device_obs(self, d: int, obs: Observation) -> Observation:
        obs = Observation.of(obs)
        scaled = obs.scaled(
            energy_factor=self.power_factors[d] * self.speed_factors[d],
            latency_factor=self.speed_factors[d])
        md = dict(scaled.metadata)
        md["device"] = d
        md["device_backend"] = md.pop("backend", None)
        md["backend"] = "fleet"
        return dataclasses.replace(scaled, metadata=md)

    def pull(self, knobs: dict, round_index: int) -> Observation:
        d = round_index % self.n_devices
        return self._device_obs(d, self.devices[d].pull(knobs, round_index))

    def pull_on(self, d: int, knobs: dict, logical_round: int
                ) -> Observation:
        """Evaluate one slot on device `d` — the asynchronous dispatch
        hook.  Uses the device's own vectorized `pull_many` (one-slot
        call) under the same round-independence rule as the synchronous
        path, so a pull produces identical numbers whichever dispatcher
        routed it."""
        dev = self.devices[d]
        fn = getattr(type(dev), "pull_many", None)
        if (fn is not None and fn is not BaseEnvironment.pull_many
                and getattr(dev, "round_independent", False)):
            obs = Observation.of(dev.pull_many([knobs], logical_round)[0])
        else:
            obs = Observation.of(dev.pull(knobs, logical_round))
        return self._device_obs(d, obs)

    def pull_duration(self, d: int) -> float:
        """Simulated wall-clock one pull occupies device `d`: the device's
        arm-measurement horizon (arrival-dominated; see
        `platform.base.measurement_horizon`) times its dispatch factor.
        Arm-independent by design — which is what makes the asynchronous
        dispatcher provably collapse to the synchronous barrier on
        homogeneous fleets."""
        return measurement_horizon(self.devices[d]) * self.dispatch_factors[d]

    def pull_many(self, knobs_list: Sequence[dict], round_index: int = 0
                  ) -> List[Observation]:
        k = len(knobs_list)
        if k == 0:
            return []
        rot = round_index // k
        out: List[Optional[Observation]] = [None] * k
        for d in range(self.n_devices):
            idxs = [i for i in range(k)
                    if (i + rot) % self.n_devices == d]
            if not idxs:
                continue
            dev = self.devices[d]
            fn = getattr(type(dev), "pull_many", None)
            if (fn is not None and fn is not BaseEnvironment.pull_many
                    and getattr(dev, "round_independent", False)):
                # Device's own vectorized hook — only for backends that
                # DECLARE round-independence: the group's logical rounds
                # are stride-N (base+d, base+d+N, ...), which the
                # slot-i = round_index + i contract cannot express in one
                # call.
                obs = [Observation.of(o) for o in dev.pull_many(
                    [knobs_list[i] for i in idxs], round_index + idxs[0])]
            else:
                # Round-sensitive/plain backends: each slot at its exact
                # global logical round (the registry contract).
                obs = [Observation.of(dev.pull(knobs_list[i],
                                               round_index + i))
                       for i in idxs]
            for i, o in zip(idxs, obs):
                out[i] = self._device_obs(d, o)
        return out  # type: ignore[return-value]

    def expected(self, knobs: dict) -> Observation:
        """Fleet-mean expected observation (available when every device's
        backend exposes `expected`, i.e. the landscape scenarios): the
        merge of the per-device noise-free observations."""
        return merge_observations([
            self._device_obs(d, dev.expected(knobs))
            for d, dev in enumerate(self.devices)])


def barrier_walltimes(env: FleetEnv, n_rounds: int, k: int,
                      pull_budget: Optional[int] = None) -> np.ndarray:
    """Cumulative simulated wall-clock at which each *synchronous* K-wide
    round's barrier releases: a round ends when its slowest device drains
    its slots (slot i of a width-w round at base pull index t goes to
    device ``(i + t // w) mod N`` — the `FleetEnv.pull_many` rule — each
    slot occupying the device for `pull_duration(d)`).  `pull_budget`
    mirrors the controllers' exact-budget semantics: the final round is
    truncated to the remaining budget, so the timeline never charges
    phantom slots.  This is the timeline the async dispatcher's
    completion clock is compared against in the straggler benchmarks —
    with one slow device the barrier inherits its dispatch factor every
    round, while the async path only waits for it on the slots it
    actually serves."""
    budget = n_rounds * k if pull_budget is None else int(pull_budget)
    clocks = np.empty(n_rounds)
    t = 0.0
    pulls = 0
    for r in range(n_rounds):
        width = min(k, budget - pulls)
        if width <= 0:
            return clocks[:r]
        rot = pulls // width
        busy = np.zeros(env.n_devices)
        for i in range(width):
            d = (i + rot) % env.n_devices
            busy[d] += env.pull_duration(d)
        t += busy.max()
        clocks[r] = t
        pulls += width
    return clocks


def make_fleet(n: int, platform: str, model: str, scenario: str, *,
               seed: int = 0, speed_jitter: float = 0.05,
               power_jitter: float = 0.05,
               dispatch_factors: Optional[Sequence[float]] = None,
               arrival_rate: Optional[float] = None, **kw) -> FleetEnv:
    """Build an N-device fleet of ``<platform>/<model>/<scenario>`` backends
    behind one shared arrival queue.

    `arrival_rate` is the FLEET total (default: 1 req/s per device, i.e.
    n, which preserves each device's paper-calibrated landscape); each
    device is constructed to drain 1/n of it.  Device d gets `seed + d`
    for its own observation noise, plus persistent lognormal speed/power
    offsets drawn from the fleet seed (sigma = `speed_jitter` /
    `power_jitter`).  `dispatch_factors` (default: all 1.0) make devices
    stragglers on the asynchronous path — device d returns each pull
    ``dispatch_factors[d]`` times slower without its telemetry changing.
    Remaining keywords pass through to every device's constructor."""
    from repro_torch.platform.registry import make_env

    if n < 1:
        raise ValueError(f"fleet size must be >= 1, got {n}")
    rate = float(n) if arrival_rate is None else float(arrival_rate)
    rng = np.random.default_rng(seed)
    speed = np.exp(speed_jitter * rng.standard_normal(n))
    power = np.exp(power_jitter * rng.standard_normal(n))
    per_device = dict(kw)
    if scenario == "events":
        # The event-driven backend parameterizes arrivals by interval.
        per_device["interval_s"] = float(n) / rate
    else:
        per_device["arrival_rate"] = rate / float(n)
    devices = [make_env(f"{platform}/{model}/{scenario}", seed=seed + d,
                        **per_device) for d in range(n)]
    return FleetEnv(devices, speed, power,
                    name=f"fleet/{n}x{platform}/{model}/{scenario}",
                    dispatch_factors=dispatch_factors)
