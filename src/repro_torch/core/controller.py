"""Online controller of the port: the MAIN loop of Algorithm 1, decoupled
from the environment (the synchronous path of `repro.core.controller`).

`BatchController` selects K arms per round from the frozen posterior,
evaluates them through `repro_torch.platform.pull_many`, and applies one
delayed batch update; `Controller` is its K=1 special case, the paper's
one-pull-per-round loop.  The random stream is one `torch.Generator`
seeded with `seed`, drawn from in round order.  The asynchronous
controller is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Protocol

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


def _argmin_most_pulled(mean, counts) -> int:
    """The commit rule: argmin of mean cost, exact ties broken toward the
    most-pulled arm, then the lowest index."""
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
            state = self._update_round(state, arms, costs)
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

    def _update_round(self, state, arms: List[int], costs: List[float]):
        fn = getattr(self.policy, "update_batch", None)
        if fn is not None:
            return fn(state, arms, costs)
        for a, c in zip(arms, costs):
            state = self.policy.update(state, a, c)
        return state


def commit_arm(state) -> int:
    """The deployed configuration after search: the arm with the lowest
    empirical mean cost, exact ties broken toward the most-pulled arm,
    then the lowest index."""
    return _argmin_most_pulled(state.mean_cost().numpy(),
                               state.count.numpy())


class Controller(BatchController):
    """The paper's sequential MAIN loop: `BatchController` with K = 1."""

    def __init__(self, space: ArmSpace, policy, cost_model: CostModel,
                 optimal_cost: Optional[float] = None, seed: int = 0):
        super().__init__(space, policy, cost_model,
                         optimal_cost=optimal_cost, seed=seed, k=1)
