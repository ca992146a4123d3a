"""Camel's Thompson-sampling bandit (paper Algorithm 1, Eqs. 13-20) — the
port of `repro.core.bandit` to PyTorch.

The cost of pulling arm i is modelled as x ~ N(theta_i, sigma1_i^2) with a
conjugate Gaussian prior theta_i ~ N(mu_i, sigma2_i^2).  After n_i
observations with sample mean xbar_i the posterior is (Eqs. 19-20):

    mu~     = (n*xi1*xbar + mu0*xi2) / (n*xi1 + xi2)
    sigma2~ = 1 / (n*xi1 + xi2)          xi1 = 1/sigma1^2, xi2 = 1/sigma2_0^2

with sigma1 estimated online from the arm's observed cost variance
(floored before two observations).

Observation delay and staleness share one sufficient-statistics state:

* `update` — the synchronous case: the observation updates the posterior
  its arm was drawn from.
* `update_batch` — bounded delay: K observations of arms selected from
  one frozen posterior arrive together; bit-identical to K chained
  `update`s for distinct arms.
* `update_stale` — unbounded delay: the cost enters the history at full
  weight, and the arm's accumulated staleness S_i inflates its effective
  observation variance, sigma1^2 * (1 + STALE_ETA * S_i / n_i);
  staleness 0 is `update` bit for bit.
* `update_censored` — a pull that produced no cost (a crash or a timeout):
  nothing enters the history, and the arm's staleness grows by
  1 + staleness, so its posterior widens and never sharpens.

Beyond the paper: `WindowedTSState` decays every arm's statistics by
`gamma` a round (drifting landscapes), and `ContextualTSState` models a
heterogeneous fleet's cost as a shared per-arm effect plus a shrunk,
centered per-device offset (see the section comment below).

The states are dataclasses of fp32/int32 tensors over the arm axis kept on
the host (49 arms: the controller reads them every round).  Sampling draws
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


def sample_thetas_many(state: TSState, gen: torch.Generator, k: int
                       ) -> Tensor:
    """K independent posterior sample vectors, f32[k, n_arms]."""
    eps = torch.randn((int(k), state.n_arms), generator=gen,
                      dtype=torch.float32)
    return state.mu + state.sigma2 * eps


def select_arms(state: TSState, gen: torch.Generator, k: int,
                active_mask: Optional[Tensor] = None) -> Tensor:
    """Batched EVAL: K arms from K independent posterior draws, without
    replacement (draw j takes the argmin over arms not yet selected).
    Returns i32[k]; k must not exceed the (active) arms."""
    if not 1 <= int(k) <= state.n_arms:
        raise ValueError(f"k must be in [1, {state.n_arms}], got {k}")
    thetas = sample_thetas_many(state, gen, k)
    if active_mask is not None:
        n_active = int(torch.as_tensor(active_mask).sum())
        if int(k) > n_active:
            raise ValueError(
                f"k={k} exceeds the {n_active} active arms in the mask")
        thetas = torch.where(torch.as_tensor(active_mask), thetas,
                             torch.full_like(thetas, float("inf")))
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


def update_censored(state: TSState, arm, staleness=0.0) -> TSState:
    """Censored UPDATE: a pull of `arm` produced no cost.  The history is
    untouched (the empirical mean must not move on evidence that never
    arrived); the arm's staleness grows by 1 + staleness, widening its
    effective observation variance, so an arm whose pulls keep failing
    gets less certain, never more, and an arm never observed stays at its
    prior."""
    onehot = torch.arange(state.n_arms) == int(arm)
    stale_n = state.stale_n + onehot * (
        1.0 + torch.as_tensor(staleness, dtype=torch.float32))
    tmp = dataclasses.replace(state, stale_n=stale_n)
    post_mu, post_sigma = _posterior_all(tmp)
    return dataclasses.replace(
        tmp, mu=torch.where(onehot, post_mu, state.mu),
        sigma2=torch.where(onehot, post_sigma, state.sigma2))


def update_streaming(state: TSState, arm, cost) -> TSState:
    """One-sample conjugate update (n = 1 in Eqs. 19-20 against the
    current posterior as prior), for non-stationary variants where
    re-deriving from the full history is wrong."""
    cost = torch.as_tensor(cost, dtype=torch.float32)
    onehot = torch.arange(state.n_arms) == int(arm)
    tmp = dataclasses.replace(
        state, count=state.count + onehot.to(torch.int32),
        sum_x=state.sum_x + onehot * cost,
        sum_x2=state.sum_x2 + onehot * cost * cost)
    sigma1 = tmp.obs_std()
    xi1 = 1.0 / (sigma1 * sigma1)
    xi2 = 1.0 / (state.sigma2 * state.sigma2)
    denom = xi1 + xi2
    post_mu = (xi1 * cost + state.mu * xi2) / denom
    post_sigma = torch.sqrt(1.0 / denom)
    return dataclasses.replace(
        tmp, mu=torch.where(onehot, post_mu, state.mu),
        sigma2=torch.where(onehot, post_sigma, state.sigma2))


# ---------------------------------------------------------------------------
# One MAIN-loop step against a cost oracle, and a loop of them
# ---------------------------------------------------------------------------

def ts_step(state: TSState, gen: torch.Generator, arm_costs: Tensor,
            cost_noise: float = 0.0, streaming: bool = False
            ) -> Tuple[TSState, int, Tensor]:
    """One bandit round against a (possibly noisy) cost oracle:
    arm_costs f32[n_arms] is each arm's true expected cost.  Returns
    (new_state, pulled_arm, observed_cost)."""
    arm = select_arm(state, gen)
    noise = cost_noise * torch.randn((), generator=gen, dtype=torch.float32)
    cost = torch.as_tensor(arm_costs, dtype=torch.float32)[arm] + noise
    upd = update_streaming if streaming else update
    return upd(state, arm, cost), arm, cost


def run_bandit(gen: torch.Generator, arm_costs, n_rounds: int,
               prior_mu: float = 1.0, prior_sigma: float = 1.0,
               cost_noise: float = 0.0, streaming: bool = False
               ) -> Tuple[TSState, Tensor, Tensor]:
    """`n_rounds` of `ts_step`: returns (final_state, arms i32[T],
    costs f32[T])."""
    arm_costs = torch.as_tensor(arm_costs, dtype=torch.float32)
    state = init_state(arm_costs.shape[0], prior_mu, prior_sigma)
    arms, costs = [], []
    for _ in range(n_rounds):
        state, arm, cost = ts_step(state, gen, arm_costs, cost_noise,
                                   streaming)
        arms.append(arm)
        costs.append(cost)
    return (state, torch.tensor(arms, dtype=torch.int32),
            torch.stack(costs) if costs else torch.zeros(0))


# ---------------------------------------------------------------------------
# Beyond the paper: sliding-window TS for non-stationary workloads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WindowedTSState:
    """Gaussian-Gaussian TS whose sufficient statistics decay by `gamma`
    a round, bounding the effective history to ~1/(1-gamma) pulls."""

    base: TSState
    gamma: Tensor  # f32 scalar decay in (0, 1]

    @property
    def n_arms(self) -> int:
        return self.base.n_arms


def init_windowed(n_arms: int, gamma: float = 0.98, prior_mu=1.0,
                  prior_sigma=1.0) -> WindowedTSState:
    return WindowedTSState(base=init_state(n_arms, prior_mu, prior_sigma),
                           gamma=torch.tensor(gamma, dtype=torch.float32))


def windowed_update(state: WindowedTSState, arm, cost) -> WindowedTSState:
    """Decay every arm's statistics, then apply the conjugate update to
    every arm (decayed counts are real-valued; Eqs. 19-20 take fractional
    n).  The stored count is the decayed count rounded, as in the
    reference."""
    b = state.base
    g = state.gamma
    onehot = torch.arange(b.n_arms) == int(arm)
    cost = torch.as_tensor(cost, dtype=torch.float32)
    n = b.count.float() * g + onehot
    sum_x = b.sum_x * g + onehot * cost
    sum_x2 = b.sum_x2 * g + onehot * cost * cost
    xbar = sum_x / n.clamp_min(1e-6)
    var = sum_x2 / n.clamp_min(1e-6) - xbar * xbar
    sigma1 = torch.where(n >= 2.0,
                         torch.sqrt(var.clamp_min(0.0)).clamp_min(
                             _MIN_OBS_STD),
                         b.prior_sigma2.clamp_min(_MIN_OBS_STD))
    xi1 = 1.0 / (sigma1 * sigma1)
    xi2 = 1.0 / (b.prior_sigma2 * b.prior_sigma2)
    denom = n * xi1 + xi2
    post_mu = (n * xi1 * xbar + b.prior_mu * xi2) / denom
    post_sigma = torch.sqrt(1.0 / denom)
    newb = dataclasses.replace(
        b, mu=torch.where(n > 0, post_mu, b.prior_mu),
        sigma2=torch.where(n > 0, post_sigma, b.prior_sigma2),
        count=torch.round(n).to(torch.int32), sum_x=sum_x, sum_x2=sum_x2)
    return WindowedTSState(base=newb, gamma=g)


def windowed_update_batch(state: WindowedTSState, arms, costs
                          ) -> WindowedTSState:
    """Delayed batched update: `windowed_update` chained over the K slots
    in order (each slot decays every arm before its increment, so there is
    no segment-sum form and the result depends on slot order)."""
    arms = torch.as_tensor(arms).reshape(-1)
    costs = torch.as_tensor(costs, dtype=torch.float32).reshape(-1)
    for a, c in zip(arms, costs):
        state = windowed_update(state, int(a), c)
    return state


def windowed_select(state: WindowedTSState, gen: torch.Generator,
                    active_mask: Optional[Tensor] = None) -> int:
    return select_arm(state.base, gen, active_mask)


def windowed_select_many(state: WindowedTSState, gen: torch.Generator,
                         k: int, active_mask: Optional[Tensor] = None
                         ) -> Tensor:
    return select_arms(state.base, gen, k, active_mask)


# ---------------------------------------------------------------------------
# Beyond the paper: device-contextual TS for heterogeneous fleets
# ---------------------------------------------------------------------------
#
# A fleet device carries persistent speed/power offsets, so the observed
# cost of arm a served by device d decomposes as
#
#     cost = theta_a + delta_d + noise
#
# with a shared per-arm effect theta_a (the fleet-level cost the controller
# optimizes) and a per-device additive offset delta_d.
#
# * The shared posterior is a plain `TSState` over device-corrected costs
#   (``cost - dev_offset[d]``, the offsets frozen at update time).
# * Offsets are the shrunk posterior means of delta_d given the
#   per-device residuals ``cost - arm_mean[a]``:
#       delta_hat_d = resid_sum_d / (resid_count_d + OFFSET_PRIOR * n_devices)
#   centered (mean subtracted) for identifiability.  With one device the
#   centered offset is exactly 0.0, every corrected cost equals the raw
#   cost, and the state reduces to `CamelTS` bit for bit.
# * The residual anchor `arm_mean` is a Welford running mean of corrected
#   costs, so identical observations keep ``c - m == 0.0`` exactly; a
#   first pull of an arm carries no cross-device information and never
#   touches the device statistics.

#: Prior pseudo-observations per device per device in the fleet.
OFFSET_PRIOR = 1.0


@dataclasses.dataclass(frozen=True)
class ContextualTSState:
    """Hierarchical posterior: shared per-arm effects + per-device
    offsets, as (n_arms,) and (n_devices,) vectors plus one scalar."""

    base: TSState               # shared posterior over CORRECTED costs
    arm_mean: Tensor            # f32[n_arms] Welford mean of corrected costs
    dev_resid_sum: Tensor       # f32[n_devices] sum of raw-cost residuals
    dev_resid_count: Tensor     # f32[n_devices] residuals per device
    dev_offset: Tensor          # f32[n_devices] centered shrunk offsets
    offset_lambda: Tensor       # f32 scalar prior pseudo-counts

    @property
    def n_arms(self) -> int:
        return self.base.n_arms

    @property
    def n_devices(self) -> int:
        return self.dev_offset.shape[0]

    @property
    def count(self) -> Tensor:
        """Per-arm observation counts (commit tie-breaking reads these)."""
        return self.base.count

    def mean_cost(self) -> Tensor:
        """Empirical mean of device-corrected costs per arm."""
        return self.base.mean_cost()


def init_contextual(n_arms: int, n_devices: int, prior_mu=1.0,
                    prior_sigma=1.0, offset_prior: float = OFFSET_PRIOR
                    ) -> ContextualTSState:
    if n_devices < 1:
        raise ValueError(f"need >= 1 device, got {n_devices}")
    if not offset_prior > 0.0:
        # lambda = 0 makes never-observed devices' offsets 0/0 = NaN.
        raise ValueError(f"offset_prior must be > 0, got {offset_prior}")
    zeros = torch.zeros(n_devices, dtype=torch.float32)
    return ContextualTSState(
        base=init_state(n_arms, prior_mu, prior_sigma),
        arm_mean=torch.zeros(n_arms, dtype=torch.float32),
        dev_resid_sum=zeros, dev_resid_count=zeros, dev_offset=zeros,
        offset_lambda=torch.tensor(float(offset_prior) * n_devices,
                                   dtype=torch.float32))


def _centered_offsets(resid_sum: Tensor, resid_count: Tensor,
                      offset_lambda: Tensor) -> Tensor:
    """Shrunk posterior offset means, centered; with one device exactly
    0.0."""
    raw = resid_sum / (resid_count + offset_lambda)
    return raw - raw.mean()


def contextual_update_stale(state: ContextualTSState, arm, cost, device,
                            staleness) -> ContextualTSState:
    """Device-aware UPDATE: correct the cost by the device's current
    offset, feed the shared posterior through `update_stale`, then refresh
    the offsets from the raw-cost residual.  A device id outside
    [0, n_devices) is the shared path: bit-identical to `update_stale` on
    `state.base`."""
    cost = torch.as_tensor(cost, dtype=torch.float32)
    arm, d = int(arm), int(device)
    n_dev = state.n_devices
    valid = 0 <= d < n_dev
    off = state.dev_offset[d] if valid else torch.tensor(0.0)
    corrected = cost - off
    base = update_stale(state.base, arm, corrected, staleness)

    onehot = torch.arange(state.n_arms) == arm
    n_new = base.count[arm]
    m_prev = state.arm_mean[arm]
    # Welford step; the first observation seeds the mean exactly.
    m_new = corrected if int(n_new) == 1 else \
        m_prev + (corrected - m_prev) / n_new.float()
    arm_mean = torch.where(onehot, m_new, state.arm_mean)

    # ``cost - m_new`` is attenuated by (n-1)/n (the anchor includes the
    # observation itself); n/(n-1) undoes it.
    informative = valid and int(n_new) >= 2
    nf = n_new.float()
    deatten = nf / (nf - 1.0).clamp_min(1.0)
    resid = (cost - m_new) * deatten if informative else torch.tensor(0.0)
    dev_onehot = (torch.arange(n_dev) == d) & informative
    resid_sum = state.dev_resid_sum + torch.where(
        dev_onehot, resid, torch.zeros(()))
    resid_count = state.dev_resid_count + dev_onehot.float()
    return dataclasses.replace(
        state, base=base, arm_mean=arm_mean, dev_resid_sum=resid_sum,
        dev_resid_count=resid_count,
        dev_offset=_centered_offsets(resid_sum, resid_count,
                                     state.offset_lambda))


def contextual_update(state: ContextualTSState, arm, cost, device
                      ) -> ContextualTSState:
    """Fresh device-aware UPDATE (`contextual_update_stale` at 0)."""
    return contextual_update_stale(state, arm, cost, device, 0.0)


def contextual_update_batch(state: ContextualTSState, arms, costs,
                            devices=None) -> ContextualTSState:
    """Delayed batched device-aware UPDATE: the K costs are corrected with
    the round's frozen offsets, the shared posterior takes one
    `update_batch`, and the offsets refresh once from the K residuals.
    For distinct arms the shared posterior is bit-identical to K chained
    `contextual_update`s.  ``devices=None`` (or an id outside
    [0, n_devices)) is the shared path for those slots."""
    arms = torch.as_tensor(arms, dtype=torch.long).reshape(-1)
    costs = torch.as_tensor(costs, dtype=torch.float32).reshape(-1)
    if devices is None:
        devices = torch.full(arms.shape, -1, dtype=torch.long)
    devices = torch.as_tensor(devices, dtype=torch.long).reshape(-1)
    n, n_dev = state.n_arms, state.n_devices

    valid = (devices >= 0) & (devices < n_dev)
    didx = devices.clamp(0, n_dev - 1)
    offs = torch.where(valid, state.dev_offset[didx], torch.zeros(()))
    corrected = costs - offs
    base = update_batch(state.base, arms, corrected)

    d_cnt = torch.zeros(n, dtype=torch.int32).index_add_(
        0, arms, torch.ones_like(arms, dtype=torch.int32))
    seg_sum = torch.zeros(n, dtype=torch.float32).index_add_(0, arms,
                                                             corrected)
    seg_mean = seg_sum / d_cnt.clamp_min(1).float()
    n_new = base.count
    first = (state.base.count == 0) & (d_cnt == 1)
    welford = state.arm_mean + (seg_mean - state.arm_mean) \
        * d_cnt.float() / n_new.clamp_min(1).float()
    arm_mean = torch.where(d_cnt > 0, torch.where(first, seg_sum, welford),
                           state.arm_mean)

    informative = valid & (n_new[arms] >= 2)
    nf = n_new[arms].float()
    deatten = nf / (nf - 1.0).clamp_min(1.0)
    resid = torch.where(informative, (costs - arm_mean[arms]) * deatten,
                        torch.zeros(()))
    resid_sum = state.dev_resid_sum + torch.zeros(
        n_dev, dtype=torch.float32).index_add_(0, didx, resid)
    resid_count = state.dev_resid_count + torch.zeros(
        n_dev, dtype=torch.float32).index_add_(0, didx, informative.float())
    return dataclasses.replace(
        state, base=base, arm_mean=arm_mean, dev_resid_sum=resid_sum,
        dev_resid_count=resid_count,
        dev_offset=_centered_offsets(resid_sum, resid_count,
                                     state.offset_lambda))


class ContextualTS:
    """Device-contextual Camel: shared per-arm effect + shrunk per-device
    additive offsets.  Selection and commit read only the shared
    posterior; the controller passes each observation's serving device
    through the widened update signatures (``device=`` / ``devices=``).
    ``None`` / -1 is the shared path, and with ``n_devices=1`` every path
    is bit-identical to `CamelTS`."""

    def __init__(self, n_devices: int, prior_mu=1.0, prior_sigma=1.0,
                 offset_prior: float = OFFSET_PRIOR):
        self.n_devices = int(n_devices)
        self.prior_mu = prior_mu
        self.prior_sigma = prior_sigma
        self.offset_prior = float(offset_prior)

    def init(self, n_arms: int) -> ContextualTSState:
        return init_contextual(n_arms, self.n_devices, self.prior_mu,
                               self.prior_sigma, self.offset_prior)

    def select(self, state: ContextualTSState, gen: torch.Generator,
               t: int) -> int:
        del t
        return select_arm(state.base, gen)

    def select_many(self, state: ContextualTSState, gen: torch.Generator,
                    t: int, k: int) -> Tensor:
        del t
        return select_arms(state.base, gen, k)

    def update(self, state: ContextualTSState, arm, cost, device=None
               ) -> ContextualTSState:
        return contextual_update(state, arm, cost,
                                 -1 if device is None else device)

    def update_batch(self, state: ContextualTSState, arms, costs,
                     devices=None) -> ContextualTSState:
        return contextual_update_batch(state, arms, costs, devices)

    def update_stale(self, state: ContextualTSState, arm, cost,
                     staleness: float, device=None) -> ContextualTSState:
        return contextual_update_stale(state, arm, cost,
                                       -1 if device is None else device,
                                       staleness)
