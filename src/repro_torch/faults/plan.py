"""`FaultPlan`: a deterministic, seeded schedule of injected faults (a copy
of `repro.faults.plan`: every decision is a numpy draw, so the port's equal
the reference's bit for bit).

Every fault decision — does this pull attempt fail, does this sensor
read drop out, is this request cancelled — is a pure function of the
plan's seed and the decision's identity (ticket/attempt, read index,
request id).  No shared RNG stream is consumed, so wrapping a run in a
zero-probability plan perturbs nothing: the wrapped run is bit-identical
to the bare one (asserted by the tests and `chip_smoke.py` phase 10).

The one-line spec grammar (``serve.py --faults``) is comma-separated
``key=value`` tokens:

    pull_fail=0.2        per-attempt probability a dispatched pull fails
    crash=1@3            device 1 crashes permanently from round 3 on
    throttle=0@5x2.5     device 0 thermally throttles 2.5x from round 5
    sensor_drop=0.1      per-read probability of SensorUnavailable
    sensor_nan=0.05      per-read probability of a NaN watts reading
    cancel=0.1@4.0       10% of requests abandoned 4.0 s after arrival
    deadline=3           per-pull deadline, x the fleet's nominal pull
    retries=3            dispatch attempts per pull (1 = no retry)
    backoff=0.05         base retry backoff, x the nominal pull duration
    seed=42              decision seed (independent of the run's seed)

``crash`` and ``throttle`` repeat to name several devices.  An empty
spec (or ``none``) parses to the zero plan.  See docs/RESILIENCE.md.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["FaultPlan", "parse_faults"]


def _decision_rng(seed: int, salt: str, *idx: int) -> np.random.Generator:
    """A fresh generator keyed by (seed, salt, decision identity): each
    decision draws from its own stream, so decisions are order-independent
    and repeatable regardless of what else the run evaluates."""
    key = (int(seed), zlib.crc32(salt.encode("utf-8"))) + \
        tuple(int(i) & 0xFFFFFFFF for i in idx)
    return np.random.default_rng(key)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded fault schedule + the resilience knobs that answer it.

    Probabilities are per-decision Bernoulli draws keyed by the decision
    identity; scheduled events (`crashes`, `throttles`) are exact.  The
    resilience knobs (`deadline_factor`, `max_attempts`,
    `backoff_factor`) ride along so one ``--faults`` spec configures both
    the chaos and the response; durations are expressed as multiples of
    the fleet's *nominal* pull duration (injectors convert to simulated
    seconds, see `injectors.nominal_duration`)."""

    seed: int = 0
    pull_fail: float = 0.0
    crashes: Tuple[Tuple[int, int], ...] = ()        # (device, round)
    throttles: Tuple[Tuple[int, int, float], ...] = ()  # (dev, round, x)
    sensor_drop: float = 0.0
    sensor_nan: float = 0.0
    cancel: float = 0.0
    cancel_patience_s: float = 4.0
    deadline_factor: Optional[float] = None
    max_attempts: int = 3
    backoff_factor: float = 0.05

    # -- identity ---------------------------------------------------------

    @property
    def is_zero(self) -> bool:
        """True when the plan injects nothing and changes no dispatch
        policy: wrapping with a zero plan must be a strict no-op."""
        return (self.pull_fail == 0.0 and not self.crashes
                and not self.throttles and self.sensor_drop == 0.0
                and self.sensor_nan == 0.0 and self.cancel == 0.0
                and self.deadline_factor is None)

    # -- pull / device faults --------------------------------------------

    def device_crashed(self, device: int, logical_round: int) -> bool:
        return any(d == device and logical_round >= r
                   for d, r in self.crashes)

    def throttle_factor(self, device: int, logical_round: int) -> float:
        """Multiplicative slowdown of `device` at `logical_round` (1.0 =
        healthy; concurrent throttle windows compound)."""
        f = 1.0
        for d, r, x in self.throttles:
            if d == device and logical_round >= r:
                f *= float(x)
        return f

    def pull_fault(self, ticket: int, worker: int, attempt: int,
                   logical_round: int) -> Optional[str]:
        """Dispatcher fault hook: 'crash' for a crashed device, else a
        Bernoulli 'flaky' failure keyed by (ticket, worker, attempt) —
        retrying the same ticket redraws, so transient faults clear."""
        if self.device_crashed(worker, logical_round):
            return "crash"
        if self.pull_fail > 0.0:
            rng = _decision_rng(self.seed, "pull", ticket, worker, attempt)
            if rng.random() < self.pull_fail:
                return "flaky"
        return None

    def backoff(self, ticket: int, attempt: int) -> float:
        """Exponential backoff with seeded jitter, in units of the
        nominal pull duration: ``backoff_factor * 2**(attempt-1) * j``
        with jitter ``j ~ U[1, 1.5)``.  Strictly monotone in `attempt`
        (``2 * min_jitter > max_jitter``) and deterministic per
        (seed, ticket, attempt)."""
        jitter = _decision_rng(self.seed, "backoff", ticket,
                               attempt).uniform(1.0, 1.5)
        return self.backoff_factor * (2.0 ** (attempt - 1)) * jitter

    # -- sensor faults ----------------------------------------------------

    def sensor_fault(self, read_index: int) -> Optional[str]:
        """Fault for the `read_index`-th sensor read: 'drop' (raise
        SensorUnavailable), 'nan' (NaN watts), or None.  One uniform
        draw decides both so drop+nan probabilities compose exactly."""
        if self.sensor_drop <= 0.0 and self.sensor_nan <= 0.0:
            return None
        u = _decision_rng(self.seed, "sensor", read_index).random()
        if u < self.sensor_drop:
            return "drop"
        if u < self.sensor_drop + self.sensor_nan:
            return "nan"
        return None

    # -- request faults ---------------------------------------------------

    def request_deadline(self, rid: int, arrival_s: float
                         ) -> Optional[float]:
        """Absolute sim-clock deadline for request `rid`, or None when
        the client never abandons it.  Keyed by rid only, so the same
        request is cancelled (or not) regardless of admission order."""
        if self.cancel <= 0.0:
            return None
        rng = _decision_rng(self.seed, "cancel", rid)
        if rng.random() < self.cancel:
            return float(arrival_s) + float(self.cancel_patience_s)
        return None


def _parse_event(tok: str, key: str) -> Tuple[int, int, float]:
    """'D@R' or 'D@RxF' -> (device, round, factor)."""
    try:
        dev, rest = tok.split("@", 1)
        if "x" in rest:
            rnd, fac = rest.split("x", 1)
            return int(dev), int(rnd), float(fac)
        return int(dev), int(rest), 1.0
    except ValueError:
        raise ValueError(
            f"bad --faults token {key}={tok!r}: want "
            f"'{key}=<device>@<round>'"
            + ("x<factor>" if key == "throttle" else "")) from None


def parse_faults(spec: Optional[str]) -> FaultPlan:
    """Parse the ``--faults`` spec grammar into a `FaultPlan` (see the
    module docstring for the token reference)."""
    if spec is None or not spec.strip() or spec.strip() == "none":
        return FaultPlan()
    kw: Dict[str, object] = {}
    crashes = []
    throttles = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise ValueError(f"bad --faults token {tok!r}: want key=value")
        key, val = tok.split("=", 1)
        key, val = key.strip(), val.strip()
        if key == "crash":
            d, r, _ = _parse_event(val, "crash")
            crashes.append((d, r))
        elif key == "throttle":
            throttles.append(_parse_event(val, "throttle"))
        elif key == "cancel":
            if "@" in val:
                p, patience = val.split("@", 1)
                kw["cancel"] = float(p)
                kw["cancel_patience_s"] = float(patience)
            else:
                kw["cancel"] = float(val)
        elif key in ("pull_fail", "sensor_drop", "sensor_nan"):
            kw[key] = float(val)
        elif key == "deadline":
            kw["deadline_factor"] = float(val)
        elif key == "retries":
            kw["max_attempts"] = int(val)
        elif key == "backoff":
            kw["backoff_factor"] = float(val)
        elif key == "seed":
            kw["seed"] = int(val)
        else:
            raise ValueError(f"unknown --faults key {key!r}")
    for p in ("pull_fail", "sensor_drop", "sensor_nan", "cancel"):
        v = kw.get(p)
        if v is not None and not 0.0 <= float(v) <= 1.0:
            raise ValueError(f"--faults {p}={v} outside [0, 1]")
    return FaultPlan(crashes=tuple(crashes), throttles=tuple(throttles),
                     **kw)
