"""Injector wrappers: thread a `FaultPlan` through the serving seams (a copy
of `repro.faults.injectors` over the port's tracing, sensors and
dispatcher).

* `FlakySensor` — wraps any `PowerSensor`; injects `SensorUnavailable`
  dropouts and NaN spikes per the plan's sensor schedule.
* `FaultyFleet` — wraps a fleet environment; crashes/throttles devices
  per the plan, re-dispatches crashed devices' synchronous slots to
  healthy ones, and (via `open_dispatch`) configures the resilient
  `AsyncDispatcher` — per-pull deadlines, seeded exponential backoff
  retries, quarantine — from the same plan.
* `apply_request_faults` — stamps client-abandonment deadlines onto
  engine requests; the continuous-batching engine cancels them mid-
  generate (`SlotScheduler.cancel`).

Injection emits ``fault.inject`` events (counted as
``faults_injected_total``); the degradation responses emit their own
``fault.*`` events (see docs/RESILIENCE.md for the event reference).
Wrapping with a zero plan is a strict no-op: observations, dispatch
order, and RNG streams are untouched (asserted in the tests and
`chip_smoke.py` phase 10).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

from repro_torch.faults.plan import FaultPlan
from repro_torch.obs import tracing as obslog
from repro_torch.obs.sensors import SensorUnavailable
from repro_torch.platform.base import (AsyncDispatcher, PullFault,
                                       measurement_horizon)

__all__ = ["FlakySensor", "FaultyFleet", "apply_request_faults",
           "nominal_duration", "wrap_env", "wrap_sensor"]


def nominal_duration(env) -> float:
    """The fleet's nominal pull duration in simulated seconds: the median
    *finite* per-device `pull_duration` (robust to hung devices with
    infinite dispatch factors), else the environment's measurement
    horizon.  The plan's duration-valued knobs (`deadline_factor`,
    `backoff_factor`) are multiples of this."""
    n = getattr(env, "n_devices", None)
    fn = getattr(env, "pull_duration", None)
    if n and fn is not None:
        finite = sorted(d for d in (float(fn(w)) for w in range(int(n)))
                        if math.isfinite(d))
        if finite:
            return finite[len(finite) // 2]
    return measurement_horizon(env)


class FlakySensor:
    """A `PowerSensor` whose reads fail per the plan's sensor schedule:
    'drop' raises `SensorUnavailable`, 'nan' returns a NaN watts reading.
    Decisions are keyed by the read index, so a fixed seed reproduces the
    exact fault sequence.  Pair with a fallback chain
    (``--sensor fallback:...``) or the meter's per-sample error counting
    to see the degradation side."""

    def __init__(self, inner, plan: FaultPlan):
        self._inner = inner
        self.plan = plan
        self._reads = 0
        self.faults_injected = 0

    @property
    def name(self) -> str:
        return f"flaky:{self._inner.name}"

    def read_watts(self) -> float:
        i = self._reads
        self._reads += 1
        kind = self.plan.sensor_fault(i)
        if kind is None:
            return self._inner.read_watts()
        self.faults_injected += 1
        if obslog.active():
            obslog.emit("fault.inject", fault=f"sensor_{kind}", read=i,
                        sensor=self._inner.name)
        if kind == "drop":
            raise SensorUnavailable(
                f"injected sensor dropout at read {i}")
        return float("nan")

    def close(self) -> None:
        self._inner.close()

    def __getattr__(self, attr):
        return getattr(self._inner, attr)


class FaultyFleet:
    """A fleet environment under the plan's device-fault schedule.

    Composition, not inheritance: unknown attributes forward to the
    wrapped env, and the overridden hooks change nothing when the plan is
    zero (throttle factor 1.0, no crashes, default dispatcher), so a
    zero-plan wrap is bit-identical to the bare fleet.

    * `pull_duration(d, logical_round)` — inflated by the plan's
      thermal-throttle factor for (d, round); the dispatcher passes the
      round through, so throttles slow completions without touching
      telemetry (exactly the `dispatch_factors` straggler semantics).
    * `pull_on` / `pull` — raise `PullFault("crash")` for a crashed
      device (async callers; the dispatcher retries elsewhere).
    * `pull_many` — the synchronous barrier path degrades instead of
      failing: slots mapped to a crashed device re-dispatch round-robin
      to the next healthy device (emitting ``fault.pull``); with every
      device crashed the round raises `PullFault`.
    * `open_dispatch` — the registry's `open_dispatcher` seam: returns an
      `AsyncDispatcher` configured from the plan (fault hook, deadline,
      retries, seeded backoff) over this wrapped env.
    """

    def __init__(self, env, plan: FaultPlan):
        self._env = env
        self.plan = plan
        self.name = f"faulty:{getattr(env, 'name', type(env).__name__)}"

    def __getattr__(self, attr):
        return getattr(self._env, attr)

    @property
    def n_devices(self) -> int:
        return int(getattr(self._env, "n_devices", 1))

    def _healthy(self, d: int, logical_round: int) -> int:
        """The first healthy device at or after `d` (round-robin);
        raises when the whole fleet is down."""
        n = self.n_devices
        for k in range(n):
            cand = (d + k) % n
            if not self.plan.device_crashed(cand, logical_round):
                return cand
        raise PullFault("crash", device=d)

    def pull_duration(self, d: int, logical_round: int = 0) -> float:
        return float(self._env.pull_duration(d)) * \
            self.plan.throttle_factor(d, logical_round)

    def pull_on(self, d: int, knobs: dict, logical_round: int):
        if self.plan.device_crashed(d, logical_round):
            raise PullFault("crash", device=d)
        return self._env.pull_on(d, knobs, logical_round)

    def pull(self, knobs: dict, round_index: int):
        d = round_index % self.n_devices
        h = self._healthy(d, round_index)
        if h != d and obslog.active():
            obslog.emit("fault.pull", reason="crash", worker=d,
                        redispatched_to=h, logical_round=round_index)
        return self._env.pull_on(h, knobs, round_index)

    def pull_many(self, knobs_list: Sequence[dict], round_index: int = 0
                  ) -> List:
        k = len(knobs_list)
        if k == 0:
            return []
        rot = round_index // k
        out = []
        for i, knobs in enumerate(knobs_list):
            d = (i + rot) % self.n_devices
            r = round_index + i
            h = self._healthy(d, r)
            if h != d and obslog.active():
                obslog.emit("fault.pull", reason="crash", worker=d,
                            redispatched_to=h, logical_round=r)
            out.append(self._env.pull_on(h, knobs, r))
        return out

    def _fault_hook(self):
        plan = self.plan

        def hook(ticket: int, worker: int, attempt: int,
                 logical_round: int) -> Optional[str]:
            reason = plan.pull_fault(ticket, worker, attempt,
                                     logical_round)
            if reason is not None and obslog.active():
                obslog.emit("fault.inject", fault=f"pull_{reason}",
                            ticket=ticket, worker=worker, attempt=attempt)
            return reason
        return hook

    def open_dispatch(self, n_workers: Optional[int] = None
                      ) -> AsyncDispatcher:
        plan = self.plan
        if plan.is_zero:
            return AsyncDispatcher(self, n_workers=n_workers)
        nominal = nominal_duration(self._env)
        deadline = None if plan.deadline_factor is None \
            else plan.deadline_factor * nominal
        hook = None if (plan.pull_fail == 0.0 and not plan.crashes) \
            else self._fault_hook()
        return AsyncDispatcher(
            self, n_workers=n_workers, deadline_s=deadline,
            max_attempts=plan.max_attempts,
            backoff_s=lambda t, a: plan.backoff(t, a) * nominal,
            fault_hook=hook)


def apply_request_faults(requests: Sequence, plan: FaultPlan) -> List:
    """Stamp the plan's client-abandonment deadlines onto engine
    requests (`EngineRequest.deadline_s`, absolute sim-clock).  Requests
    the plan leaves alone are returned as-is — a zero plan returns the
    input objects unchanged."""
    import dataclasses
    out = []
    for req in requests:
        deadline = plan.request_deadline(req.rid, req.arrival_s)
        out.append(req if deadline is None
                   else dataclasses.replace(req, deadline_s=deadline))
    return out


def wrap_sensor(sensor, plan: FaultPlan):
    """`FlakySensor` around `sensor` when the plan injects sensor faults,
    else `sensor` unchanged."""
    if sensor is None or (plan.sensor_drop <= 0.0
                          and plan.sensor_nan <= 0.0):
        return sensor
    return FlakySensor(sensor, plan)


def wrap_env(env, plan: FaultPlan):
    """`FaultyFleet` around a fleet-like env (has `n_devices` +
    `pull_on`) when the plan is non-zero, else `env` unchanged.  Plain
    environments pass through — their fault surface is the sensor and
    request seams."""
    if plan.is_zero:
        return env
    if getattr(env, "n_devices", 0) and hasattr(env, "pull_on"):
        return FaultyFleet(env, plan)
    return env
