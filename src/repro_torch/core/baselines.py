"""Search policies of the port: Camel's Thompson sampling (`CamelTS`)
behind the bandit interface the controller swaps policies through —
``select(state, gen, t) -> arm`` and ``update(state, arm, cost) ->
state``, plus the batched pair ``select_many`` / ``update_batch`` and the
asynchronous ``update_stale``.  Policies only ever see scalar costs: the
controller reduces each `Observation` through the CostModel.

The reference's grid, UCB1, epsilon-greedy, random, windowed and
contextual policies are not ported yet (ROADMAP.md, Queue 1)."""

from __future__ import annotations

from typing import Protocol

import torch

from repro_torch.core import bandit


class Policy(Protocol):
    def init(self, n_arms: int): ...
    def select(self, state, gen: torch.Generator, t: int) -> int: ...
    def update(self, state, arm, cost): ...


class CamelTS:
    """prior_mu / prior_sigma may be scalars or per-arm tensors."""

    def __init__(self, prior_mu=1.0, prior_sigma=1.0):
        self.prior_mu = prior_mu
        self.prior_sigma = prior_sigma

    def init(self, n_arms: int) -> bandit.TSState:
        return bandit.init_state(n_arms, self.prior_mu, self.prior_sigma)

    def select(self, state: bandit.TSState, gen: torch.Generator,
               t: int) -> int:
        del t
        return bandit.select_arm(state, gen)

    def update(self, state: bandit.TSState, arm, cost) -> bandit.TSState:
        return bandit.update(state, arm, cost)

    def select_many(self, state: bandit.TSState, gen: torch.Generator,
                    t: int, k: int) -> torch.Tensor:
        del t
        return bandit.select_arms(state, gen, k)

    def update_batch(self, state: bandit.TSState, arms, costs
                     ) -> bandit.TSState:
        return bandit.update_batch(state, arms, costs)

    def update_stale(self, state: bandit.TSState, arm, cost,
                     staleness: float) -> bandit.TSState:
        return bandit.update_stale(state, arm, cost, staleness)


POLICIES = {"camel": CamelTS}


def make_policy(name: str, **kwargs) -> Policy:
    try:
        return POLICIES[name](**kwargs)
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; have {sorted(POLICIES)}")
