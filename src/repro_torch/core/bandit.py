"""Camel's Thompson-sampling bandit (paper Algorithm 1, Eqs. 13-20) — the
`TSState` path of `repro.core.bandit` in PyTorch.

The cost of pulling arm i is modelled as x ~ N(theta_i, sigma1_i^2) with a
conjugate Gaussian prior theta_i ~ N(mu_i, sigma2_i^2).  After n_i
observations with sample mean xbar_i the posterior is (Eqs. 19-20):

    mu~     = (n*xi1*xbar + mu0*xi2) / (n*xi1 + xi2)
    sigma2~ = 1 / (n*xi1 + xi2)          xi1 = 1/sigma1^2, xi2 = 1/sigma2_0^2

with sigma1 estimated online from the arm's observed cost variance
(floored before two observations).  `update_stale` inflates sigma1^2 by
(1 + STALE_ETA * S_i / n_i) for accumulated staleness S_i; staleness 0 is
`update` bit for bit.  `update_batch` records K observations at once and is
bit-identical to K chained `update`s for distinct arms.

The state is a dataclass of fp32/int32 tensors over the arm axis kept on
the host (49 arms: the controller reads it every round).  Sampling draws
from an explicit `torch.Generator`; its stream differs from JAX's, so the
tests match selection by distribution and the deterministic updates
exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

_MIN_OBS_STD = 1e-3
_MIN_PRIOR_STD = 1e-6

#: Variance-inflation rate per unit of accumulated staleness.
STALE_ETA = 0.5


@dataclasses.dataclass(frozen=True)
class TSState:
    """Posterior state for Gaussian-Gaussian Thompson sampling over n arms.
    All leaves have leading dim n_arms."""

    mu: Tensor            # posterior mean of theta_i          (f32[n])
    sigma2: Tensor        # posterior *std* of theta_i         (f32[n])
    prior_mu: Tensor      # prior mean  mu_0                   (f32[n])
    prior_sigma2: Tensor  # prior std  sigma2_0                (f32[n])
    count: Tensor         # n_i observations                   (i32[n])
    sum_x: Tensor         # sum of observed costs              (f32[n])
    sum_x2: Tensor        # sum of squared observed costs      (f32[n])
    stale_n: Tensor       # accumulated observation staleness  (f32[n])

    @property
    def n_arms(self) -> int:
        return self.mu.shape[0]

    def mean_cost(self) -> Tensor:
        """Empirical mean cost per arm (prior mean where unpulled)."""
        safe = self.count.clamp_min(1)
        emp = self.sum_x / safe
        return torch.where(self.count > 0, emp, self.prior_mu)

    def obs_std(self) -> Tensor:
        """sigma1 estimate per arm = std of observed costs."""
        safe = self.count.clamp_min(1)
        mean = self.sum_x / safe
        var = (self.sum_x2 / safe - mean * mean).clamp_min(0.0)
        std = torch.sqrt(var)
        return torch.where(self.count >= 2, std.clamp_min(_MIN_OBS_STD),
                           self.prior_sigma2.clamp_min(_MIN_OBS_STD))


def _f32(x, n: int) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32).expand(n).clone()


def init_state(n_arms: int, prior_mu=1.0, prior_sigma=1.0) -> TSState:
    """Fresh posterior = prior (default N(1, 1): the cost at (max f,
    max b) is normalized to 1)."""
    pm = _f32(prior_mu, n_arms)
    ps = _f32(prior_sigma, n_arms).clamp_min(_MIN_PRIOR_STD)
    zeros = torch.zeros(n_arms, dtype=torch.float32)
    return TSState(mu=pm, sigma2=ps, prior_mu=pm, prior_sigma2=ps,
                   count=torch.zeros(n_arms, dtype=torch.int32),
                   sum_x=zeros, sum_x2=zeros, stale_n=zeros)


# ---------------------------------------------------------------------------
# EVAL (Alg. 1 lines 7-14)
# ---------------------------------------------------------------------------

def sample_thetas(state: TSState, gen: torch.Generator) -> Tensor:
    """Draw one theta per arm from its posterior."""
    eps = torch.randn(state.n_arms, generator=gen, dtype=torch.float32)
    return state.mu + state.sigma2 * eps


def select_arm(state: TSState, gen: torch.Generator,
               active_mask: Optional[Tensor] = None) -> int:
    """argmin over sampled thetas (cost-minimizing TS)."""
    thetas = sample_thetas(state, gen)
    if active_mask is not None:
        thetas = torch.where(active_mask, thetas,
                             torch.full_like(thetas, float("inf")))
    return int(torch.argmin(thetas))


def select_arms(state: TSState, gen: torch.Generator, k: int) -> Tensor:
    """Batched EVAL: K arms from K independent posterior draws, without
    replacement.  Returns i32[k]."""
    if not 1 <= int(k) <= state.n_arms:
        raise ValueError(f"k must be in [1, {state.n_arms}], got {k}")
    eps = torch.randn((int(k), state.n_arms), generator=gen,
                      dtype=torch.float32)
    thetas = state.mu + state.sigma2 * eps
    taken = torch.zeros(state.n_arms, dtype=torch.bool)
    arms = []
    for th in thetas:
        arm = int(torch.argmin(torch.where(
            taken, torch.full_like(th, float("inf")), th)))
        taken[arm] = True
        arms.append(arm)
    return torch.tensor(arms, dtype=torch.int32)


# ---------------------------------------------------------------------------
# UPDATE (Alg. 1 lines 15-18 + Eqs. 19-20)
# ---------------------------------------------------------------------------

def _posterior_all(state: TSState) -> Tuple[Tensor, Tensor]:
    """Eqs. 19-20 for every arm from its sufficient statistics, with the
    staleness inflation folded into the observation precision."""
    n = state.count.float()
    xbar = state.sum_x / n.clamp_min(1.0)
    sigma1 = state.obs_std()
    inflation = 1.0 + STALE_ETA * state.stale_n / n.clamp_min(1.0)
    xi1 = 1.0 / (sigma1 * sigma1 * inflation)
    xi2 = 1.0 / (state.prior_sigma2 * state.prior_sigma2)
    denom = n * xi1 + xi2
    post_mu = (n * xi1 * xbar + state.prior_mu * xi2) / denom   # Eq. 19
    post_sigma = torch.sqrt(1.0 / denom)                        # Eq. 20
    return post_mu, post_sigma


def update(state: TSState, arm, cost) -> TSState:
    """Record `cost` for `arm` and recompute that arm's posterior from its
    full history against the original prior."""
    return update_stale(state, arm, cost, 0.0)


def update_stale(state: TSState, arm, cost, staleness) -> TSState:
    """Staleness-aware UPDATE: the cost enters the history at full weight,
    the arm's accumulated staleness inflates its observation variance
    (staleness 0 is `update` bit for bit)."""
    cost = torch.as_tensor(cost, dtype=torch.float32)
    onehot = torch.arange(state.n_arms) == int(arm)
    count = state.count + onehot.to(torch.int32)
    sum_x = state.sum_x + onehot * cost
    sum_x2 = state.sum_x2 + onehot * cost * cost
    stale_n = state.stale_n + onehot * torch.as_tensor(
        staleness, dtype=torch.float32)
    tmp = dataclasses.replace(state, count=count, sum_x=sum_x,
                              sum_x2=sum_x2, stale_n=stale_n)
    post_mu, post_sigma = _posterior_all(tmp)
    return dataclasses.replace(
        tmp, mu=torch.where(onehot, post_mu, state.mu),
        sigma2=torch.where(onehot, post_sigma, state.sigma2))


def update_batch(state: TSState, arms, costs) -> TSState:
    """Delayed batched UPDATE: segment-sum K observations into the
    sufficient statistics and recompute every touched arm's posterior once
    — bit-identical to K chained `update`s when the arms are distinct."""
    arms = torch.as_tensor(arms, dtype=torch.long).reshape(-1)
    costs = torch.as_tensor(costs, dtype=torch.float32).reshape(-1)
    n = state.n_arms
    d_count = torch.zeros(n, dtype=torch.int32).index_add_(
        0, arms, torch.ones_like(arms, dtype=torch.int32))
    d_sum = torch.zeros(n, dtype=torch.float32).index_add_(0, arms, costs)
    d_sum2 = torch.zeros(n, dtype=torch.float32).index_add_(
        0, arms, costs * costs)
    touched = d_count > 0
    tmp = dataclasses.replace(state, count=state.count + d_count,
                              sum_x=state.sum_x + d_sum,
                              sum_x2=state.sum_x2 + d_sum2)
    post_mu, post_sigma = _posterior_all(tmp)
    return dataclasses.replace(
        tmp, mu=torch.where(touched, post_mu, state.mu),
        sigma2=torch.where(touched, post_sigma, state.sigma2))
