"""Online controller of the port: the MAIN loop of Algorithm 1, decoupled
from the environment (the port of `repro.core.controller`).

Three loops, three observation-delay regimes:

* `Controller` — zero delay: each observation updates the posterior it
  was selected from (the paper's one-pull-per-round loop).
* `BatchController` — bounded delay: K arms per round from the frozen
  posterior, evaluated through `repro_torch.platform.pull_many`, then ONE
  delayed batch update; a straggler stalls the round, but no observation
  is stale.  `Controller` is its K=1 special case.
* `AsyncController` — completion-ordered: K arms in flight through the
  dispatcher (`platform.open_dispatcher`); slots refill as devices finish,
  and an observation arriving `s` posterior refreshes after its selection
  goes through the policy's `update_stale(arm, cost, s)`.  On an
  equal-speed fleet with K equal to the device count every staleness is
  0 and the records equal `BatchController`'s.

The random stream is one `torch.Generator` seeded with `seed`, drawn from
in selection order, so the batch and async loops consume it alike.  A
policy whose updates take ``device=`` / ``devices=`` (`_accepts_kw`) gets
each observation's serving device from ``obs.metadata["device"]``.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.arms import ArmSpace
from repro_torch.core.cost import CostModel, RegretTracker, summarize_run
from repro_torch.obs import tracing as obslog
from repro_torch.platform.base import FailedPull
from repro_torch.platform.telemetry import Observation


class Environment(Protocol):
    """Pull an arm; observe the resulting per-request telemetry."""

    def pull(self, knobs: Dict[str, object], round_index: int
             ) -> Observation: ...


def _accepts_kw(fn, name: str) -> bool:
    """True when `fn` can take keyword `name` (device-context widening):
    an explicit parameter or **kwargs."""
    if fn is None:
        return False
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):  # builtins / C callables
        return False
    return name in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def _argmin_most_pulled(mean, counts) -> int:
    """The commit rule: argmin of mean cost, exact ties broken toward the
    most-pulled arm, then the lowest index.  The one implementation: the
    live commit and `_per_record_commit_history` both call it."""
    mean = np.asarray(mean, dtype=float)
    counts = np.asarray(counts)
    best = mean == mean.min()
    return int(np.argmax(np.where(best, counts, -1)))


@dataclasses.dataclass
class RoundRecord:
    t: int                          # global pull index (round * k + slot)
    arm: int
    knobs: Dict[str, object]
    energy: float
    latency: float
    cost: float
    regret: float
    obs: Optional[Observation] = None
    round: int = 0                  # batched round this pull belonged to
    slot: int = 0                   # position within the round's K slots


@dataclasses.dataclass
class ControllerResult:
    records: List[RoundRecord]
    final_state: object
    best_arm: int
    best_knobs: Dict[str, object]
    cum_regret: np.ndarray
    failed_pulls: List[FailedPull] = dataclasses.field(
        default_factory=list)

    def summary(self) -> dict:
        e = np.array([r.energy for r in self.records])
        l = np.array([r.latency for r in self.records])
        c = np.array([r.cost for r in self.records])
        out = summarize_run(e, l, c)
        out["cum_regret"] = float(self.cum_regret[-1]) if len(
            self.cum_regret) else 0.0
        out["best_arm"] = self.best_arm
        out["best_knobs"] = dict(self.best_knobs)
        obs = [r.obs for r in self.records if r.obs is not None]
        if obs:
            out["mean_power_w"] = float(np.mean([o.power for o in obs]))
            out["mean_batch_time_s"] = float(np.mean(
                [o.batch_time for o in obs]))
            out["mean_queue_wait_s"] = float(np.mean(
                [o.queue_wait for o in obs]))
            out["saturated_rounds"] = int(sum(o.backlog > 0 for o in obs))
            out["total_tokens"] = int(sum(o.tokens for o in obs))
        if self.failed_pulls:
            out["failed_pulls"] = len(self.failed_pulls)
        return out

    def arm_counts(self, n_arms: int) -> np.ndarray:
        counts = np.zeros(n_arms, dtype=np.int64)
        for r in self.records:
            counts[r.arm] += 1
        return counts

    @property
    def n_rounds(self) -> int:
        return self.records[-1].round + 1 if self.records else 0


class BatchController:
    """Runs `policy` against `env` for T batched rounds of width K: select
    K arms from the frozen posterior (the policy's `select_many`, without
    replacement for Thompson sampling), evaluate all K through `pull_many`
    (slot i is logical round t + i), then apply ONE delayed batch update.
    The controller owns cost computation (Eq. 1 via CostModel) and regret
    accounting."""

    def __init__(self, space: ArmSpace, policy, cost_model: CostModel,
                 optimal_cost: Optional[float] = None, seed: int = 0,
                 k: int = 1):
        if not 1 <= int(k) <= space.n_arms:
            raise ValueError(f"k must be in [1, {space.n_arms}], got {k}")
        self.space = space
        self.policy = policy
        self.cost_model = cost_model
        self.optimal_cost = optimal_cost
        self.gen = torch.Generator().manual_seed(seed)
        self.k = int(k)
        self._batch_wants_devices = _accepts_kw(
            getattr(policy, "update_batch", None), "devices")
        self._update_wants_device = _accepts_kw(
            getattr(policy, "update", None), "device")
        self._stale_wants_device = _accepts_kw(
            getattr(policy, "update_stale", None), "device")

    def run(self, env: Environment, n_rounds: int,
            pull_budget: Optional[int] = None) -> ControllerResult:
        """T batched rounds of width K; `pull_budget` (default
        ``n_rounds * k``) caps the total pulls exactly."""
        from repro_torch.platform.registry import pull_many

        budget = n_rounds * self.k if pull_budget is None else int(
            pull_budget)
        if pull_budget is not None and \
                not 1 <= budget <= n_rounds * self.k:
            raise ValueError(
                f"pull_budget must be in [1, {n_rounds * self.k}] "
                f"(n_rounds * k), got {pull_budget}")
        state = self.policy.init(self.space.n_arms)
        regret = RegretTracker(self.optimal_cost
                               if self.optimal_cost is not None else 0.0)
        records: List[RoundRecord] = []

        t = 0
        rnd = 0
        tracing = obslog.active()
        while t < budget:
            width = min(self.k, budget - t)
            if tracing:
                obslog.emit("round.start", round=rnd, t=t, width=width)
            t0 = time.monotonic()
            arms = self._select_group(state, t, width)
            knobs_list = [self.space.values(a) for a in arms]
            obs_list = [Observation.of(o)
                        for o in pull_many(env, knobs_list, round_index=t)]
            costs = [float(self.cost_model.cost(o.energy, o.latency))
                     for o in obs_list]
            devices = [o.metadata.get("device") for o in obs_list]
            state = self._update_round(state, arms, costs, devices)
            if tracing:
                obslog.emit("update", round=rnd, n=len(arms), arms=arms,
                            policy=type(self.policy).__name__)
            for slot, (arm, knobs, obs, c) in enumerate(
                    zip(arms, knobs_list, obs_list, costs)):
                r = regret.record(c) if self.optimal_cost is not None else 0.0
                records.append(RoundRecord(
                    t=t, arm=arm, knobs=knobs, energy=obs.energy,
                    latency=obs.latency, cost=c, regret=float(r), obs=obs,
                    round=rnd, slot=slot))
                if tracing:
                    self._emit_pull(records[-1])
                t += 1
            if tracing:
                obslog.emit("round", dur_s=time.monotonic() - t0,
                            round=rnd, width=width)
            rnd += 1

        best_arm = commit_arm(state)
        if tracing:
            obslog.emit("commit", best_arm=int(best_arm),
                        knobs=self.space.values(best_arm),
                        n_pulls=len(records))
        return ControllerResult(
            records=records, final_state=state, best_arm=best_arm,
            best_knobs=self.space.values(best_arm), cum_regret=regret.curve)

    @staticmethod
    def _emit_pull(rec: RoundRecord) -> None:
        md = rec.obs.metadata if rec.obs is not None else {}
        obslog.emit(
            "pull", t=rec.t, round=rec.round, slot=rec.slot,
            arm=int(rec.arm), knobs=dict(rec.knobs),
            energy_j=float(rec.energy), latency_s=float(rec.latency),
            edp=float(rec.energy) * float(rec.latency),
            cost=float(rec.cost), regret=float(rec.regret),
            power_w=float(rec.obs.power) if rec.obs is not None else None,
            device=md.get("device"), staleness=md.get("staleness"),
            tokens_per_s=md.get("tokens_per_s"))

    def _select_group(self, state, t: int, width: int) -> List[int]:
        if width == 1:
            return [int(self.policy.select(state, self.gen, t + 1))]
        fn = getattr(self.policy, "select_many", None)
        if fn is not None:
            return [int(a) for a in fn(state, self.gen, t + 1, width)]
        # Policies without a batched form: scalar selects against the
        # frozen state, with replacement.
        return [int(self.policy.select(state, self.gen, t + 1 + i))
                for i in range(width)]

    def _update_round(self, state, arms: List[int], costs: List[float],
                      devices: Optional[Sequence] = None):
        """Apply one round's delayed feedback; each slot's serving device
        (None for deviceless environments) reaches the policy only when
        its update signature asks for it."""
        if devices is None:
            devices = [None] * len(arms)
        dev = [-1 if d is None else int(d) for d in devices]
        fn = getattr(self.policy, "update_batch", None)
        if fn is not None:
            if self._batch_wants_devices:
                return fn(state, arms, costs,
                          devices=torch.tensor(dev, dtype=torch.int32))
            return fn(state, arms, costs)
        for a, c, d in zip(arms, costs, dev):
            if self._update_wants_device:
                state = self.policy.update(state, a, c, device=d)
            else:
                state = self.policy.update(state, a, c)
        return state


def commit_arm(state) -> int:
    """The deployed configuration after search: the arm with the lowest
    posterior/empirical mean cost, exact ties broken toward the
    most-pulled arm, then the lowest index (`_argmin_most_pulled`)."""
    mean = getattr(state, "mean_cost", None)
    if callable(mean):
        return _argmin_most_pulled(mean().numpy(), state.count.numpy())
    base = getattr(state, "base", None)
    if base is not None and hasattr(base, "mean_cost"):
        return _argmin_most_pulled(base.mean_cost().numpy(),
                                   base.count.numpy())
    # Grid/UCB-style states expose count & sum_x.
    counts = state.count.numpy()
    sums = state.sum_x.numpy()
    m = np.where(counts > 0, sums / np.maximum(counts, 1), np.inf)
    return _argmin_most_pulled(m, counts)


class Controller(BatchController):
    """The paper's sequential MAIN loop: `BatchController` with K = 1."""

    def __init__(self, space: ArmSpace, policy, cost_model: CostModel,
                 optimal_cost: Optional[float] = None, seed: int = 0):
        super().__init__(space, policy, cost_model,
                         optimal_cost=optimal_cost, seed=seed, k=1)


class AsyncController(BatchController):
    """Straggler-tolerant asynchronous MAIN loop: K arms in flight through
    a completion-ordered dispatcher instead of K arms behind a round
    barrier.

    Whenever slots are free (and budget remains), select that many arms
    from the current posterior and submit them to
    `repro_torch.platform.open_dispatcher(env)`; then drain the next
    completion wave (every pull finishing at the earliest outstanding
    instant) and apply each completion through the policy's
    `update_stale(arm, cost, staleness)`, staleness counting the
    posterior-refresh events between the arm's selection and its arrival.
    A completion whose every attempt failed goes through
    `update_censored` where the policy has one, and is recorded in
    `failed_pulls`; it still consumes budget.

    On a fleet whose devices share one pull duration, with K equal to the
    device count, every refill is a full group, every wave returns all K,
    every staleness is 0 and the records equal `BatchController.run`'s.
    Each record's `round`/`slot` are its wave and position in it, and its
    `obs.metadata` gains `submitted_at` / `finished_at` (the dispatcher's
    simulated clock) and `staleness`.
    """

    def run(self, env: Environment, n_rounds: int,
            pull_budget: Optional[int] = None) -> ControllerResult:
        from repro_torch.platform.registry import open_dispatcher

        budget = n_rounds * self.k if pull_budget is None else int(
            pull_budget)
        if pull_budget is not None and \
                not 1 <= budget <= n_rounds * self.k:
            raise ValueError(
                f"pull_budget must be in [1, {n_rounds * self.k}] "
                f"(n_rounds * k), got {pull_budget}")
        disp = open_dispatcher(env)
        state = self.policy.init(self.space.n_arms)
        regret = RegretTracker(self.optimal_cost
                               if self.optimal_cost is not None else 0.0)
        records: List[RoundRecord] = []
        failed: List[FailedPull] = []
        in_flight: Dict[int, Tuple[int, Dict, int]] = {}
        submitted = completed = 0
        events = 0            # posterior-refresh events (waves applied)

        tracing = obslog.active()
        while completed < budget:
            t0 = time.monotonic()
            n_new = min(self.k - len(in_flight), budget - submitted)
            if n_new > 0:
                if tracing:
                    obslog.emit("round.start", round=events, t=submitted,
                                width=n_new)
                for a in self._select_group(state, submitted, n_new):
                    knobs = self.space.values(a)
                    ticket = disp.submit(knobs, submitted)
                    in_flight[ticket] = (a, knobs, events)
                    submitted += 1
            wave = disp.pop_wave()
            for slot, comp in enumerate(wave):
                arm, knobs, epoch = in_flight.pop(comp.ticket)
                staleness = events - epoch
                obs = comp.obs
                if obs is None:
                    # Every dispatch attempt failed: no cost arrived, so
                    # the posterior mean must not move.
                    failed.append(FailedPull(
                        ticket=comp.ticket, worker=comp.worker,
                        knobs=knobs, reason=comp.fault or "unknown",
                        submitted_at=comp.submitted_at,
                        failed_at=comp.finished_at,
                        attempts=comp.attempts))
                    state = self._update_censored(state, arm, staleness)
                    if tracing:
                        obslog.emit("update.censored", arm=int(arm),
                                    reason=comp.fault,
                                    staleness=staleness, wave=events,
                                    attempts=comp.attempts,
                                    policy=type(self.policy).__name__)
                    completed += 1
                    continue
                c = float(self.cost_model.cost(obs.energy, obs.latency))
                state = self._update_stale(state, arm, c, staleness,
                                           obs.metadata.get("device"))
                if tracing:
                    obslog.emit("update.stale", arm=int(arm), cost=c,
                                staleness=staleness, wave=events,
                                device=obs.metadata.get("device"),
                                policy=type(self.policy).__name__)
                r = regret.record(c) if self.optimal_cost is not None else 0.0
                records.append(RoundRecord(
                    t=completed, arm=arm, knobs=knobs, energy=obs.energy,
                    latency=obs.latency, cost=c, regret=float(r),
                    obs=dataclasses.replace(
                        obs, metadata={**obs.metadata,
                                       "submitted_at": comp.submitted_at,
                                       "finished_at": comp.finished_at,
                                       "staleness": staleness}),
                    round=events, slot=slot))
                if tracing:
                    self._emit_pull(records[-1])
                completed += 1
            if tracing:
                obslog.emit("round", dur_s=time.monotonic() - t0,
                            round=events, width=len(wave),
                            clock_s=disp.clock)
            events += 1

        best_arm = commit_arm(state)
        if tracing:
            obslog.emit("commit", best_arm=int(best_arm),
                        knobs=self.space.values(best_arm),
                        n_pulls=len(records))
        return ControllerResult(
            records=records, final_state=state, best_arm=best_arm,
            best_knobs=self.space.values(best_arm),
            cum_regret=regret.curve, failed_pulls=failed)

    def _update_censored(self, state, arm: int, staleness: int):
        """A failed completion: the policy's `update_censored` where it
        has one, else no update."""
        fn = getattr(self.policy, "update_censored", None)
        if fn is None:
            return state
        return fn(state, arm, float(staleness))

    def _update_stale(self, state, arm: int, cost: float, staleness: int,
                      device=None):
        """Apply one completion; the serving device reaches the policy
        only when its update signature asks for it.  Policies without a
        staleness notion (grid, UCB, ...) take late observations as
        fresh."""
        dev_kw = {}
        fn = getattr(self.policy, "update_stale", None)
        if fn is not None:
            if self._stale_wants_device:
                dev_kw = {"device": -1 if device is None else int(device)}
            return fn(state, arm, cost, float(staleness), **dev_kw)
        if self._update_wants_device:
            dev_kw = {"device": -1 if device is None else int(device)}
        return self.policy.update(state, arm, cost, **dev_kw)


# ---------------------------------------------------------------------------
# Convergence measures over recorded runs
# ---------------------------------------------------------------------------

def _per_record_commit_history(records: List[RoundRecord], prior_mu,
                               n_arms: int) -> np.ndarray:
    """The arm the controller would commit to after each pull, with the
    commit rule for mean-cost states (mean observed cost, prior mean where
    unpulled, `_argmin_most_pulled` tie-breaking).  The one copy of that
    reconstruction: `committed_best_history` samples it at round
    boundaries and `walltime_to_converge` reads it per completion."""
    cnt = np.zeros(n_arms)
    s = np.zeros(n_arms)
    prior = np.broadcast_to(np.asarray(prior_mu, float), (n_arms,))
    hist = np.empty(len(records), dtype=int)
    for i, rec in enumerate(records):
        cnt[rec.arm] += 1
        s[rec.arm] += rec.cost
        mean = np.where(cnt > 0, s / np.maximum(cnt, 1), prior)
        hist[i] = _argmin_most_pulled(mean, cnt)
    return hist


def committed_best_history(records: List[RoundRecord],
                           prior_mu, n_arms: int) -> List[int]:
    """The committed arm after each controller round: the per-record
    commit history sampled at the last record of each `round` value (so
    a truncated final round or a ragged async wave still counts)."""
    hist = _per_record_commit_history(records, prior_mu, n_arms)
    return [int(hist[i]) for i, rec in enumerate(records)
            if i + 1 == len(records) or records[i + 1].round != rec.round]


def rounds_to_converge(records: List[RoundRecord], opt_arm: int,
                       prior_mu, n_arms: int) -> Optional[int]:
    """First round (1-based) after which the committed arm equals
    `opt_arm` and never leaves it; None if the run never settles there."""
    hist = committed_best_history(records, prior_mu, n_arms)
    for i in range(len(hist)):
        if all(b == opt_arm for b in hist[i:]):
            return i + 1
    return None


def pulls_to_converge(records: List[RoundRecord], opt_arm: int,
                      prior_mu, n_arms: int) -> Optional[int]:
    """Pulls (1-based) after which the committed arm equals `opt_arm` and
    never leaves it, comparable across round widths."""
    hist = _per_record_commit_history(records, prior_mu, n_arms)
    settled = None
    for i in range(len(hist) - 1, -1, -1):
        if hist[i] != opt_arm:
            break
        settled = i + 1
    return settled


def record_clocks(records: List[RoundRecord]) -> np.ndarray:
    """Per-record completion clock of an `AsyncController` run (the
    dispatcher's simulated `finished_at`)."""
    return np.array([r.obs.metadata["finished_at"] for r in records])


def walltime_to_converge(records: List[RoundRecord], clocks,
                         opt_arm: int, prior_mu, n_arms: int
                         ) -> Optional[float]:
    """Simulated wall-clock at which the commit settles on `opt_arm`: the
    clock of the first completion after which the committed-best rule
    never leaves it.  `clocks` aligns with `records` (`record_clocks` for
    async runs, `platform.fleet.barrier_walltimes` expanded per slot for
    synchronous ones).  None if the run never settles on `opt_arm`."""
    hist = _per_record_commit_history(records, prior_mu, n_arms)
    clocks = np.asarray(clocks, float)
    settled = None
    for i in range(len(hist) - 1, -1, -1):
        if hist[i] != opt_arm:
            break
        settled = float(clocks[i])
    return settled


def landscape_optimal(space: ArmSpace,
                      env_expected: Callable[[Dict], Observation],
                      cost_model: CostModel) -> Tuple[int, float]:
    """Exhaustively evaluate the noise-free landscape for the optimal arm
    and its cost (seeds RegretTracker).  `env_expected` may return an
    Observation or an (energy, latency) pair."""
    best_arm, best_cost = -1, float("inf")
    for arm, knobs in space.enumerate():
        e, l = env_expected(knobs)
        c = float(cost_model.cost(e, l))
        if c < best_cost:
            best_arm, best_cost = arm, c
    return best_arm, best_cost
