"""The `Platform` contract of the port: one hardware abstraction for every
backend — the port of `repro.platform.base` (framework-free; its
`TPUPlatform` is not ported, see ROADMAP.md).

* `levels` — the knob values the arm space enumerates (DVFS frequencies in
  MHz on a Jetson board);
* `power(level, util)` — mean watts at a level and utilization;
* `set_level(level)` — actuate the level (simulation adapters record it; a
  real deployment writes the devfreq sysfs node here).

Environments expose two evaluation paths with different delay contracts:

* `pull` / `pull_many` — synchronous: a K-wide round is a barrier,
  released when the slowest device finishes (slot i is logical round
  ``round_index + i``; see registry.pull_many).
* `AsyncDispatcher` — asynchronous: `submit` hands a pull to a worker and
  returns; results come back through a completion queue in finish order.
  A pull submitted under one posterior may complete many refreshes later:
  that delay is the staleness `bandit.update_stale` discounts for.

The dispatcher is a deterministic simulated event clock: a pull's
observation is computed at submission but delivered at
``start + duration`` on its worker's timeline, the duration being the
device's arm-measurement horizon (`measurement_horizon`).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, List, Optional, Protocol, Sequence, \
    Tuple, runtime_checkable

from repro_torch.obs import tracing as obslog
from repro_torch.platform.telemetry import Observation


@runtime_checkable
class Platform(Protocol):
    """Frequency/perf-level hardware abstraction."""

    @property
    def name(self) -> str: ...

    @property
    def knob_name(self) -> str:
        """Arm-space knob this platform's levels populate
        (e.g. 'freq_mhz', 'perf_state')."""
        ...

    @property
    def levels(self) -> Tuple[float, ...]: ...

    @property
    def n_levels(self) -> int: ...

    def level_of(self, value) -> int: ...

    def power(self, level: int, util: float = 1.0) -> float: ...

    def set_level(self, level: int) -> None: ...


class _LevelMixin:
    """Shared level bookkeeping for the concrete adapters."""

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def level_of(self, value) -> int:
        for i, v in enumerate(self.levels):
            if abs(float(v) - float(value)) < 1e-6:
                return i
        raise ValueError(f"{value!r} is not a level of {self.name}; "
                         f"have {tuple(self.levels)}")

    def set_level(self, level: int) -> None:
        if not 0 <= int(level) < self.n_levels:
            raise ValueError(f"level {level} out of range "
                             f"[0, {self.n_levels}) for {self.name}")
        self.current_level = int(level)


class DVFSPlatform(_LevelMixin):
    """Adapter: a DVFS board (e.g. `serving.energy.DVFSBoard`) as a
    Platform.  Levels are the board's DVFS frequencies in MHz."""

    knob_name = "freq_mhz"

    def __init__(self, board):
        self.board = board
        self.current_level = board.n_levels - 1

    @property
    def name(self) -> str:
        return self.board.name

    @property
    def levels(self) -> Tuple[float, ...]:
        return tuple(self.board.freqs_mhz)

    def power(self, level: int, util: float = 1.0) -> float:
        return self.board.power(level, util)


def as_platform(hw) -> Platform:
    """Wrap a raw hardware profile in its Platform adapter (idempotent)."""
    if isinstance(hw, DVFSPlatform):
        return hw
    if hasattr(hw, "freqs_mhz"):
        return DVFSPlatform(hw)
    if isinstance(hw, Platform):
        return hw
    raise TypeError(f"cannot adapt {type(hw).__name__} to Platform")


class BaseEnvironment:
    """Optional base class for environments: carries the `platform` handle
    and supplies the sequential `pull_many` fallback of the batched-
    evaluation hook (async/sharded controllers and the registry's
    `pull_many` call it; vectorized backends override it).

    A backend whose observations do not depend on `round_index` (the
    closed-form landscapes) sets `round_independent = True`; composite
    dispatchers (the fleet) only hand such backends a whole slot group in
    one vectorized call, because a group's logical rounds are generally
    non-contiguous and cannot be expressed through the slot-i =
    round_index + i contract."""

    platform: Platform = None
    round_independent: bool = False

    def pull(self, knobs, round_index: int) -> Observation:
        raise NotImplementedError

    def pull_many(self, knobs_list: Sequence[dict], round_index: int = 0
                  ) -> List[Observation]:
        """Sequential fallback of the batched hook.  Contract: slot i is
        logical round ``round_index + i`` (see registry.pull_many);
        vectorized overrides must preserve that mapping wherever their
        dynamics depend on the round."""
        return [Observation.of(self.pull(k, round_index + i))
                for i, k in enumerate(knobs_list)]


@dataclasses.dataclass(frozen=True)
class FailedPull:
    """One failed pull attempt (or a fully exhausted pull): which worker
    it was tried on, why it failed, and when on the simulated timeline.
    The dispatcher records one per failed *attempt*; the controller
    records one per pull whose every attempt failed."""

    ticket: int               # the pull's ticket (shared across attempts)
    worker: int               # worker the attempt ran on (-1: none healthy)
    knobs: Dict[str, object]  # the arm's knob values
    reason: str               # "crash" | "flaky" | "timeout" | ...
    submitted_at: float       # dispatcher clock at submission
    failed_at: float          # simulated instant the failure surfaced
    attempts: int             # attempt count when this failure happened


# ---------------------------------------------------------------------------
# Asynchronous completion-ordered dispatch
# ---------------------------------------------------------------------------


def measurement_horizon(env) -> float:
    """Simulated wall-clock one arm pull occupies a device.

    A pull is a *measurement*: it observes a fixed arrival window (the
    landscape scenarios integrate over `n_requests` arrivals at
    `arrival_rate`; the events scenario replays `requests_per_pull`
    arrivals spaced `interval_s`), so to first order its duration is the
    arrival horizon, independent of the arm — we deliberately ignore the
    saturated-arm service tail.  Environments without arrival bookkeeping
    get one logical slot tick per pull."""
    rate = getattr(env, "arrival_rate", None)
    n = getattr(env, "n_requests", None)
    if rate and n:
        return float(n) / float(rate)
    interval = getattr(env, "interval_s", None)
    per_pull = getattr(env, "requests_per_pull", None)
    if interval and per_pull:
        return float(interval) * float(per_pull)
    return 1.0


class PullFault(RuntimeError):
    """A pull failed at the device: raised by an environment's `pull` /
    `pull_on` (or synthesized by a fault hook) to signal that no
    observation was produced.  `reason` is a short machine-readable tag
    ("crash", "flaky", "timeout", ...); the dispatcher's retry policy
    keys off it (crash/timeout quarantine the worker, flaky does not)."""

    def __init__(self, reason: str, device: Optional[int] = None):
        msg = reason if device is None else f"{reason} (device {device})"
        super().__init__(msg)
        self.reason = str(reason)
        self.device = device


@dataclasses.dataclass(frozen=True)
class Completion:
    """One finished asynchronous pull, as delivered by the completion
    queue: which worker served it, what it observed, and when on the
    simulated timeline it was submitted and finished.  When every retry
    attempt failed, the completion is still delivered — with `obs=None`
    and `fault` naming the last failure reason — so the completion queue
    never silently drops a ticket."""

    ticket: int               # submission order (0-based, globally unique)
    worker: int               # device/worker index that served the pull
    knobs: Dict[str, object]  # the arm's knob values
    obs: Optional[Observation]  # what the pull observed (None on fault)
    submitted_at: float       # dispatcher clock at submission
    finished_at: float        # dispatcher clock at completion
    attempts: int = 1         # how many dispatch attempts it took
    fault: Optional[str] = None  # last failure reason when obs is None


class AsyncDispatcher:
    """Completion-ordered dispatch of arm pulls over an environment's
    workers — the asynchronous counterpart of `registry.pull_many`.

    Workers map to fleet devices (`env.n_devices`, pulls evaluated via
    `env.pull_on`) or to a single logical worker for plain environments
    (`env.pull`).  `submit(knobs, logical_round)` assigns the pull to the
    worker that can start it earliest — ties broken by a rotation that
    advances one worker per completion wave, matching `FleetEnv`'s
    synchronous round-robin so the two dispatch paths agree device-by-
    device on homogeneous fleets — and schedules its completion at
    ``start + duration`` (per-worker duration: `env.pull_duration(d)` when
    available, else `measurement_horizon(env)`).  `pop_wave()` advances
    the clock to the earliest outstanding completion and returns *all*
    completions sharing that finish time, in submission order: on an
    equal-speed fleet a full-width submission group returns as one wave,
    which is exactly the synchronous barrier — stragglers make waves
    ragged instead of stalling them.

    Fault tolerance (all off by default; the default path is bit-identical
    to the fault-free dispatcher):

    * `deadline_s` — per-attempt deadline on the simulated clock.  An
      attempt whose duration would exceed it (e.g. a hung device with an
      infinite `dispatch_factor`) *times out* at ``start + deadline_s``,
      the worker is quarantined (it is wedged on the abandoned pull), and
      the pull is re-dispatched to a healthy worker — `pop_wave` no
      longer stalls forever behind one hung device.
    * `fault_hook(ticket, worker, attempt, logical_round)` — injection
      seam: returns a failure reason (or None) *before* evaluation; a
      fault plan plugs in here.  Environments may equivalently raise
      `PullFault` from `pull` / `pull_on`.
    * retry — failed attempts are retried up to `max_attempts` times on
      the earliest-free *healthy* worker, delayed by
      ``backoff_s(ticket, attempt)`` (seeded exponential backoff when a
      fault plan supplies it).  Reasons in `quarantine_reasons` mark the
      failing worker unhealthy first, so retries re-dispatch elsewhere.
    * exhaustion — when every attempt fails (or no healthy worker is
      left) the pull still completes: `pop_wave` delivers a `Completion`
      with ``obs=None`` and `fault` set, so the controller can record a
      `FailedPull` and its budget loop still terminates.
    """

    def __init__(self, env, n_workers: Optional[int] = None, *,
                 deadline_s: Optional[float] = None,
                 max_attempts: int = 3,
                 backoff_s: Optional[Callable[[int, int], float]] = None,
                 fault_hook: Optional[
                     Callable[[int, int, int, int], Optional[str]]] = None,
                 quarantine_reasons: Sequence[str] = ("crash", "timeout")):
        self.env = env
        self.n_workers = int(n_workers or getattr(env, "n_devices", 1))
        if self.n_workers < 1:
            raise ValueError(f"need >= 1 worker, got {self.n_workers}")
        self.clock = 0.0
        self._free_at = [0.0] * self.n_workers
        self._pending: List[Completion] = []
        self._tickets = 0
        self._waves = 0
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.max_attempts = max(1, int(max_attempts))
        self.backoff_s = backoff_s
        self.fault_hook = fault_hook
        self.quarantine_reasons = frozenset(quarantine_reasons)
        self.quarantined: set = set()
        self.failed: List[FailedPull] = []
        self.retries = 0
        fn = getattr(env, "pull_duration", None)
        self._dur_wants_round = False
        if fn is not None:
            try:
                self._dur_wants_round = \
                    len(inspect.signature(fn).parameters) >= 2
            except (TypeError, ValueError):
                pass

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def _duration(self, worker: int, logical_round: int = 0) -> float:
        fn = getattr(self.env, "pull_duration", None)
        if fn is not None:
            if self._dur_wants_round:
                return float(fn(worker, logical_round))
            return float(fn(worker))
        return measurement_horizon(self.env)

    def _evaluate(self, worker: int, knobs: Dict, logical_round: int
                  ) -> Observation:
        fn = getattr(self.env, "pull_on", None)
        if fn is not None:
            return Observation.of(fn(worker, knobs, logical_round))
        return Observation.of(self.env.pull(knobs, logical_round))

    def _record_failure(self, ticket: int, worker: int, knobs: Dict,
                        reason: str, fail_at: float, attempt: int,
                        logical_round: int) -> None:
        self.failed.append(FailedPull(
            ticket=ticket, worker=worker, knobs=dict(knobs), reason=reason,
            submitted_at=self.clock, failed_at=fail_at, attempts=attempt))
        if obslog.active():
            obslog.emit("fault.pull", ticket=ticket, worker=worker,
                        reason=reason, attempt=attempt,
                        logical_round=logical_round, failed_at=fail_at)

    def submit(self, knobs: Dict, logical_round: int) -> int:
        """Dispatch one pull; returns its ticket.  The observation is
        computed eagerly (deterministic simulation) but only delivered by
        `pop_wave` once the worker's timeline reaches its finish.  Failed
        attempts retry on healthy workers; a fully failed pull enqueues a
        faulted completion instead of an observation."""
        ticket = self._tickets
        self._tickets += 1
        earliest = self.clock          # backoff pushes retries later
        last_reason = "no-healthy-worker"
        last_worker = -1
        fail_at = self.clock
        attempts_used = 0
        for attempt in range(1, self.max_attempts + 1):
            cands = [w for w in range(self.n_workers)
                     if w not in self.quarantined]
            if not cands:
                break
            starts = {w: max(self._free_at[w], earliest) for w in cands}
            w = min(cands, key=lambda d: (
                starts[d], (d - self._waves) % self.n_workers))
            start = starts[w]
            duration = self._duration(w, logical_round)
            attempts_used = attempt
            last_worker = w
            reason = None
            obs = None
            if self.fault_hook is not None:
                reason = self.fault_hook(ticket, w, attempt, logical_round)
            if reason is None:
                if self.deadline_s is not None and duration > self.deadline_s:
                    reason = "timeout"
                else:
                    try:
                        obs = self._evaluate(w, knobs, logical_round)
                    except PullFault as pf:
                        reason = pf.reason
            if reason is None:
                finish = start + duration
                self._free_at[w] = finish
                comp = Completion(ticket=ticket, worker=w,
                                  knobs=dict(knobs), obs=obs,
                                  submitted_at=self.clock,
                                  finished_at=finish, attempts=attempt)
                self._pending.append(comp)
                if obslog.active():
                    obslog.emit("dispatch.submit", ticket=ticket, worker=w,
                                logical_round=logical_round,
                                submitted_at=self.clock, finished_at=finish)
                return ticket
            # Failure: surface time, health bookkeeping, then maybe retry.
            if reason == "timeout":
                fail_at = start + self.deadline_s
                # The worker is wedged on the abandoned pull: never free.
                self._free_at[w] = float("inf")
                self.quarantined.add(w)
            else:
                fail_at = start + duration
                self._free_at[w] = fail_at
                if reason in self.quarantine_reasons:
                    self.quarantined.add(w)
            if self.quarantined and obslog.active() and \
                    w in self.quarantined:
                obslog.emit("fault.device", worker=w, reason=reason,
                            quarantined=sorted(self.quarantined))
            self._record_failure(ticket, w, knobs, reason, fail_at,
                                 attempt, logical_round)
            last_reason = reason
            delay = self.backoff_s(ticket, attempt) if self.backoff_s \
                else 0.0
            earliest = fail_at + delay
            if attempt < self.max_attempts:
                self.retries += 1
                if obslog.active():
                    obslog.emit("fault.retry", ticket=ticket,
                                attempt=attempt, backoff_s=delay,
                                next_start=earliest)
        # Every attempt failed (or no healthy worker left): deliver the
        # fault through the completion queue so the caller's wave loop
        # still sees this ticket complete.
        comp = Completion(ticket=ticket, worker=last_worker,
                          knobs=dict(knobs), obs=None,
                          submitted_at=self.clock,
                          finished_at=max(fail_at, self.clock),
                          attempts=attempts_used, fault=last_reason)
        self._pending.append(comp)
        if obslog.active():
            obslog.emit("dispatch.submit", ticket=ticket,
                        worker=last_worker, logical_round=logical_round,
                        submitted_at=self.clock,
                        finished_at=comp.finished_at, fault=last_reason)
        return ticket

    def pop_wave(self) -> List[Completion]:
        """Advance the clock to the earliest outstanding completion and
        return every completion finishing at that instant (submission
        order).  Raises if nothing is in flight."""
        if not self._pending:
            raise RuntimeError("pop_wave with no pulls in flight")
        t = min(c.finished_at for c in self._pending)
        wave = sorted((c for c in self._pending if c.finished_at == t),
                      key=lambda c: c.ticket)
        self._pending = [c for c in self._pending if c.finished_at != t]
        self.clock = t
        self._waves += 1
        if obslog.active():
            obslog.emit("dispatch.wave", wave=self._waves - 1,
                        size=len(wave), clock_s=t,
                        in_flight=len(self._pending),
                        tickets=[c.ticket for c in wave])
        return wave
