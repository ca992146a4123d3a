"""Search policies of the port: grid search (the paper's comparison), UCB1,
epsilon-greedy, random, Camel's Thompson sampling (`CamelTS`), its
sliding-window variant and the device-contextual `bandit.ContextualTS`.

All share the bandit interface the controller swaps policies through —
``select(state, gen, t) -> arm`` and ``update(state, arm, cost) ->
state`` — and may add the batched pair ``select_many(state, gen, t, k)`` /
``update_batch(state, arms, costs)``, the asynchronous
``update_stale(state, arm, cost, staleness)`` and the censored
``update_censored(state, arm, staleness)``.  A policy that wants to know
which device served an observation widens its updates with keyword-only
context (``device=`` / ``devices=``); the controllers detect the keyword
and pass the id from ``obs.metadata["device"]``.  Policies only ever see
scalar costs: the controller reduces each `Observation` through the
CostModel.  Randomness comes from the controller's `torch.Generator`."""

from __future__ import annotations

import dataclasses
from typing import Protocol

import torch

from repro_torch.core import bandit

Tensor = torch.Tensor


class Policy(Protocol):
    def init(self, n_arms: int): ...
    def select(self, state, gen: torch.Generator, t: int) -> int: ...
    def update(self, state, arm, cost): ...


@dataclasses.dataclass(frozen=True)
class CountState:
    """Per-arm pull counts and cost sums (UCB1, epsilon-greedy, random)."""

    count: Tensor   # i32[n]
    sum_x: Tensor   # f32[n]


def _count_init(n_arms: int) -> CountState:
    return CountState(count=torch.zeros(n_arms, dtype=torch.int32),
                      sum_x=torch.zeros(n_arms, dtype=torch.float32))


def _count_update(state, arm, cost):
    onehot = torch.arange(state.count.shape[0]) == int(arm)
    return dataclasses.replace(
        state, count=state.count + onehot.to(torch.int32),
        sum_x=state.sum_x + onehot * torch.as_tensor(cost,
                                                     dtype=torch.float32))


def _mean_or_inf(state) -> Tensor:
    mean = state.sum_x / state.count.clamp_min(1).float()
    return torch.where(state.count > 0, mean,
                       torch.full_like(mean, float("inf")))


# ---------------------------------------------------------------------------
# Grid search: pull arms in index order (the paper's uniform 1/49 sweep).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GridState:
    next_arm: int    # the next arm of the sweep
    n_arms_: int
    count: Tensor    # i32[n]
    sum_x: Tensor    # f32[n]


class GridSearch:
    """Deterministic sweep over all arms in index order; after one full
    pass it commits to the empirical argmin (how the paper's baseline
    serves after its 49 search rounds)."""

    def init(self, n_arms: int) -> GridState:
        c = _count_init(n_arms)
        return GridState(next_arm=0, n_arms_=n_arms, count=c.count,
                         sum_x=c.sum_x)

    def select(self, state: GridState, gen: torch.Generator, t: int) -> int:
        del gen, t
        if bool((state.count > 0).all()):
            return int(torch.argmin(_mean_or_inf(state)))
        return state.next_arm % state.n_arms_

    def update(self, state: GridState, arm, cost) -> GridState:
        state = _count_update(state, arm, cost)
        return dataclasses.replace(
            state, next_arm=(state.next_arm + 1) % state.n_arms_)

    def select_many(self, state: GridState, gen: torch.Generator, t: int,
                    k: int) -> Tensor:
        """A K-wide round sweeps the next K arms in index order; after the
        full pass every slot commits to the empirical argmin."""
        del gen, t
        if bool((state.count > 0).all()):
            return torch.full((k,), int(torch.argmin(_mean_or_inf(state))),
                              dtype=torch.int32)
        return ((state.next_arm + torch.arange(k, dtype=torch.int32))
                % state.n_arms_).to(torch.int32)

    def update_batch(self, state: GridState, arms, costs) -> GridState:
        for a, c in zip(arms, costs):
            state = self.update(state, a, c)
        return state


# ---------------------------------------------------------------------------
# UCB1 (minimization form): pull argmin(mean - c*sqrt(2 ln t / n_i)).
# ---------------------------------------------------------------------------

UCBState = CountState


class UCB1:
    def __init__(self, c: float = 1.0):
        self.c = float(c)

    def init(self, n_arms: int) -> UCBState:
        return _count_init(n_arms)

    def select(self, state: UCBState, gen: torch.Generator, t: int) -> int:
        del gen
        n = state.count.float()
        mean = state.sum_x / n.clamp_min(1.0)
        tf = torch.tensor(float(t), dtype=torch.float32).clamp_min(1.0)
        bonus = self.c * torch.sqrt(2.0 * torch.log(tf) / n.clamp_min(1.0))
        lcb = torch.where(state.count > 0, mean - bonus,
                          torch.full_like(mean, -float("inf")))
        return int(torch.argmin(lcb))

    def update(self, state: UCBState, arm, cost) -> UCBState:
        return _count_update(state, arm, cost)


# ---------------------------------------------------------------------------
# Epsilon-greedy and random.
# ---------------------------------------------------------------------------

class EpsilonGreedy:
    """With probability eps a uniformly random arm, else the empirical
    argmin (an unpulled arm first)."""

    def __init__(self, eps: float = 0.1):
        self.eps = float(eps)

    def init(self, n_arms: int) -> UCBState:
        return _count_init(n_arms)

    def select(self, state: UCBState, gen: torch.Generator, t: int) -> int:
        del t
        explore = float(torch.rand((), generator=gen)) < self.eps
        rand = int(torch.randint(0, state.count.shape[0], (),
                                 generator=gen))
        if explore:
            return rand
        if bool((state.count == 0).any()):
            return int(torch.argmin(state.count))
        return int(torch.argmin(_mean_or_inf(state)))

    def update(self, state: UCBState, arm, cost) -> UCBState:
        return _count_update(state, arm, cost)


class RandomPolicy:
    def init(self, n_arms: int) -> UCBState:
        return _count_init(n_arms)

    def select(self, state: UCBState, gen: torch.Generator, t: int) -> int:
        del t
        return int(torch.randint(0, state.count.shape[0], (), generator=gen))

    def update(self, state: UCBState, arm, cost) -> UCBState:
        return _count_update(state, arm, cost)


# ---------------------------------------------------------------------------
# Camel (Thompson sampling) in the same interface.
# ---------------------------------------------------------------------------

class CamelTS:
    """prior_mu / prior_sigma may be scalars or per-arm tensors (the
    structured priors of `core.priors`).  `streaming` swaps in the
    one-sample update."""

    def __init__(self, prior_mu=1.0, prior_sigma=1.0,
                 streaming: bool = False):
        self.prior_mu = prior_mu
        self.prior_sigma = prior_sigma
        self.streaming = streaming

    def init(self, n_arms: int) -> bandit.TSState:
        return bandit.init_state(n_arms, self.prior_mu, self.prior_sigma)

    def select(self, state: bandit.TSState, gen: torch.Generator,
               t: int) -> int:
        del t
        return bandit.select_arm(state, gen)

    def update(self, state: bandit.TSState, arm, cost) -> bandit.TSState:
        if self.streaming:
            return bandit.update_streaming(state, arm, cost)
        return bandit.update(state, arm, cost)

    def select_many(self, state: bandit.TSState, gen: torch.Generator,
                    t: int, k: int) -> Tensor:
        del t
        return bandit.select_arms(state, gen, k)

    def update_batch(self, state: bandit.TSState, arms, costs
                     ) -> bandit.TSState:
        if self.streaming:
            for a, c in zip(arms, costs):
                state = bandit.update_streaming(state, a, c)
            return state
        return bandit.update_batch(state, arms, costs)

    def update_stale(self, state: bandit.TSState, arm, cost,
                     staleness: float) -> bandit.TSState:
        """Staleness-inflated Eqs. 19-20; the streaming variant has no
        full-history form to inflate and ignores staleness."""
        if self.streaming:
            return bandit.update_streaming(state, arm, cost)
        return bandit.update_stale(state, arm, cost, staleness)

    def update_censored(self, state: bandit.TSState, arm,
                        staleness: float = 0.0) -> bandit.TSState:
        """A failed pull: variance inflation only (a no-op for the
        streaming variant, which has no sufficient statistics)."""
        if self.streaming:
            return state
        return bandit.update_censored(state, arm, staleness)


class CamelWindowedTS:
    """Sliding-window Camel for non-stationary workloads."""

    def __init__(self, gamma: float = 0.98, prior_mu=1.0, prior_sigma=1.0):
        self.gamma = gamma
        self.prior_mu = prior_mu
        self.prior_sigma = prior_sigma

    def init(self, n_arms: int) -> bandit.WindowedTSState:
        return bandit.init_windowed(n_arms, self.gamma, self.prior_mu,
                                    self.prior_sigma)

    def select(self, state, gen: torch.Generator, t: int) -> int:
        del t
        return bandit.windowed_select(state, gen)

    def update(self, state, arm, cost):
        return bandit.windowed_update(state, arm, cost)

    def select_many(self, state, gen: torch.Generator, t: int, k: int
                    ) -> Tensor:
        del t
        return bandit.windowed_select_many(state, gen, k)

    def update_batch(self, state, arms, costs):
        return bandit.windowed_update_batch(state, arms, costs)

    def update_stale(self, state, arm, cost, staleness: float):
        """The window already discounts old evidence by recency of update,
        which is when a late completion lands."""
        del staleness
        return bandit.windowed_update(state, arm, cost)


POLICIES = {
    "camel": CamelTS,
    # device-contextual Camel (requires n_devices=)
    "contextual": bandit.ContextualTS,
    "camel_windowed": CamelWindowedTS,
    "grid": GridSearch,
    "ucb1": UCB1,
    "eps_greedy": EpsilonGreedy,
    "random": RandomPolicy,
}


def make_policy(name: str, **kwargs) -> Policy:
    try:
        return POLICIES[name](**kwargs)
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; have {sorted(POLICIES)}")
