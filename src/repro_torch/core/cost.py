"""Cost metric (paper Eq. 1), normalization, EDP, and regret accounting.

cost(E, L) = alpha * E/E_ref + (1 - alpha) * L/L_ref

The paper normalizes by the (max frequency, max batch) configuration
(following EcoEdgeInfer): its E and L define E_ref/L_ref so its cost is 1.
EDP = E * L (energy-delay product, the headline metric).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostModel:
    """alpha-weighted normalized cost."""

    alpha: float = 0.5
    energy_ref: float = 1.0   # Joules/request at the reference arm
    latency_ref: float = 1.0  # seconds/request at the reference arm

    def __post_init__(self):
        if not (0.0 <= self.alpha <= 1.0):
            raise ValueError(f"alpha must be in [0,1], got {self.alpha}")
        if self.energy_ref <= 0 or self.latency_ref <= 0:
            raise ValueError("reference energy/latency must be positive")

    def cost(self, energy: float, latency: float) -> float:
        """Eq. 1 weighted normalized cost (works on scalars or arrays)."""
        return (self.alpha * (energy / self.energy_ref)
                + (1.0 - self.alpha) * (latency / self.latency_ref))

    @staticmethod
    def edp(energy, latency):
        """Energy-delay product (J*s per request^2 scale)."""
        return energy * latency

    @staticmethod
    def normalized(values, ref: float):
        return np.asarray(values) / ref

    def with_reference(self, energy_ref: float, latency_ref: float
                       ) -> "CostModel":
        return dataclasses.replace(
            self, energy_ref=energy_ref, latency_ref=latency_ref)


def reference_from_landscape(energies: np.ndarray, latencies: np.ndarray,
                             ref_arm: int) -> Tuple[float, float]:
    """E_ref, L_ref from the landscape at the paper's reference arm
    (max freq, max batch)."""
    return float(energies[ref_arm]), float(latencies[ref_arm])


@dataclasses.dataclass
class RegretTracker:
    """Cumulative regret vs. the best fixed arm (paper Fig. 5).

    regret_t = cost(pulled arm at t) - cost(optimal arm); optimal is defined
    against the *expected* landscape (noise-free), as in the paper's setup
    where both algorithms replay identical data points.
    """

    optimal_cost: float
    cum_regret: float = 0.0
    history: list = dataclasses.field(default_factory=list)

    def record(self, observed_cost: float) -> float:
        r = float(observed_cost) - self.optimal_cost
        self.cum_regret += r
        self.history.append(self.cum_regret)
        return r

    @property
    def curve(self) -> np.ndarray:
        return np.asarray(self.history)


def summarize_run(energies: np.ndarray, latencies: np.ndarray,
                  costs: np.ndarray) -> dict:
    """Per-run averages used in the paper's Fig. 3 bar groups."""
    energies = np.asarray(energies, dtype=np.float64)
    latencies = np.asarray(latencies, dtype=np.float64)
    costs = np.asarray(costs, dtype=np.float64)
    return {
        "energy_per_req": float(energies.mean()),
        "latency_per_req": float(latencies.mean()),
        "edp": float((energies * latencies).mean()),
        "cost": float(costs.mean()),
    }
