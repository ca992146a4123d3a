"""Structured priors for Camel's Thompson sampler — a copy of
`repro.core.priors` (framework-free) on the port's own modules.

The paper stresses that "Camel integrates prior knowledge to balance
exploration and exploitation".  We operationalize that: per-arm prior means
mu_0[i] are seeded from the paper's *analytical* cost model (Eq. 8 plus the
queueing-saturation term) evaluated with deliberately coarse, uncalibrated
constants, scaled by a single probe measurement (one batch at (f_max,
b_min)).  The bandit then corrects the analytical model online.

This is exactly the "one cheap probe + physics" bootstrap an operator can
always do, and it is what lets Camel skip catastrophically saturated arms
without ever pulling them (paper Fig. 6: Camel's exploration heatmap is
concentrated; grid's is uniform).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.arms import ArmSpace
from repro_torch.platform.telemetry import queueing_latency


@dataclasses.dataclass(frozen=True)
class CoarsePhysics:
    """Uncalibrated generic DVFS physics for the prior (NOT the simulator's
    ground-truth constants)."""

    kappa: float = 0.30       # generic memory-bound share
    c0_units: float = 8.0     # generic batch overhead (units of c_p)
    p_static: float = 10.0    # W
    c_eff: float = 50.0       # W/(V^2 GHz)
    v0: float = 0.60          # V(f) = v0 + kv * f_ghz (generic linear ladder)
    kv: float = 0.35


def analytic_cost_prior(
    space: ArmSpace,
    probe_batch_time_s: float,
    probe_batch: int,
    arrival_rate: float = 1.0,
    n_requests: int = 2500,
    alpha: float = 0.5,
    physics: CoarsePhysics = CoarsePhysics(),
    freq_knob: str = "freq_mhz",
    batch_knob: str = "batch",
    prior_sigma: float = 0.10,
    sigma_inflate_far: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-arm (prior_mu, prior_sigma) from coarse physics + one probe.

    probe_batch_time_s: measured t_batch at (f_max, probe_batch) — a single
    real batch execution.  Everything else is generic.

    Returns prior_mu[n_arms], prior_sigma[n_arms] (both normalized so the
    (max f, max b) reference arm's predicted cost is 1).  Arms whose
    predicted cost is far from 1 get an inflated sigma — the coarse model is
    least trustworthy exactly where it predicts extremes.
    """
    freqs = np.asarray(space.grid(freq_knob), dtype=np.float64)
    f_max = freqs.max()
    ph = physics

    # Probe pins t_unit: tb = t_unit * (c0 + b) at f_max.
    t_unit = probe_batch_time_s / (ph.c0_units + probe_batch)

    n = space.n_arms
    E = np.zeros(n)
    L = np.zeros(n)
    for arm, knobs in space.enumerate():
        f = float(knobs[freq_knob])
        b = int(knobs[batch_knob])
        f_ghz = f / 1000.0
        v = ph.v0 + ph.kv * f_ghz
        p = ph.p_static + ph.c_eff * v * v * f_ghz
        factor = ph.kappa + (1.0 - ph.kappa) * f_max / f
        tb = t_unit * (ph.c0_units + b) * factor
        E[arm] = p * tb / b
        L[arm] = queueing_latency(tb, b, arrival_rate, n_requests).total

    ref = space.corner()  # (max f, max b)
    chat = alpha * E / E[ref] + (1.0 - alpha) * L / L[ref]

    sigma = np.full(n, prior_sigma)
    far = np.abs(np.log(np.maximum(chat, 1e-9)))  # distance from cost 1.0
    sigma = sigma * (1.0 + (sigma_inflate_far - 1.0) *
                     np.minimum(far / np.log(4.0), 1.0))
    return chat.astype(np.float32), sigma.astype(np.float32)


def flat_prior(space: ArmSpace, prior_mu: float = 1.0,
               prior_sigma: float = 0.10) -> Tuple[np.ndarray, np.ndarray]:
    """The uninformative alternative (ablation baseline)."""
    n = space.n_arms
    return (np.full(n, prior_mu, np.float32),
            np.full(n, prior_sigma, np.float32))


def jetson_camel_policy(model: str, space: ArmSpace, alpha: float = 0.5):
    """The standard Camel search policy for a calibrated Orin workload:
    CamelTS seeded with the analytic cost prior, probed with one batch at
    (f_max, b=4) — the one recipe serve.py, the benchmarks, the examples
    and the tests all share.

    Returns (policy, prior_mu, prior_sigma); the prior vectors also feed
    commit reconstruction (`controller.rounds_to_converge`).
    """
    from repro_torch.core import baselines
    from repro_torch.serving import energy

    board = energy.JETSON_AGX_ORIN
    work = energy.ORIN_WORKLOADS[model]
    probe_tb = work.batch_time(board, board.n_levels - 1, 4)
    mu0, sig0 = analytic_cost_prior(space, probe_tb, 4, alpha=alpha)
    policy = baselines.make_policy("camel", prior_mu=mu0, prior_sigma=sig0)
    return policy, mu0, sig0


def jetson_contextual_policy(model: str, space: ArmSpace, n_devices: int,
                             alpha: float = 0.5):
    """Device-contextual variant of `jetson_camel_policy`: the same
    analytic Camel prior on the shared per-arm effects, with
    `bandit.ContextualTS` learning per-device cost offsets on top — the
    one recipe serve.py's fleet modes, the E11 benchmark, and
    examples/fleet_serving.py all share.  Returns (policy, mu0, sig0)."""
    from repro_torch.core import baselines

    _, mu0, sig0 = jetson_camel_policy(model, space, alpha)
    policy = baselines.make_policy("contextual", n_devices=n_devices,
                                   prior_mu=mu0, prior_sigma=sig0)
    return policy, mu0, sig0
