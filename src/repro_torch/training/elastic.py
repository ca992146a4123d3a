"""Elastic scaling + straggler mitigation (DESIGN.md SS5), the port's copy
of `repro.training.elastic` (a module without JAX in it, kept here so that
the port imports nothing of the reference).

Elastic re-shard: when hosts fail, training resumes on a smaller mesh —
checkpoints are topology-free (plain arrays), so resuming is: build the
survivor mesh, re-derive the partitioning and reshard.
`shrink_data_axis` computes the largest viable survivor mesh.  The port
trains on one card: its mesh and dry-run tooling is ROADMAP.md Queue 1
item 9c.

Straggler watchdog: per-step wall-time EWMA with z-score flagging; in a real
deployment the flagged host is cordoned and the elastic path above kicks in
(here: it reports, and the train loop raises after `patience` consecutive
flags so the harness restarts on the survivor mesh).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple


def shrink_data_axis(n_alive: int, model_parallel: int,
                     ) -> Tuple[int, int]:
    """Largest (data, model) mesh <= n_alive chips keeping `model_parallel`
    intact (model groups must stay whole — TP has state entanglement)."""
    if n_alive < model_parallel:
        raise ValueError(
            f"cannot keep model_parallel={model_parallel} with only "
            f"{n_alive} chips")
    data = n_alive // model_parallel
    return data, model_parallel


def reshard_plan(old_shape: Tuple[int, int], n_alive: int,
                 ) -> dict:
    """Describes the elastic transition (for logs / tests)."""
    data, model = shrink_data_axis(n_alive, old_shape[1])
    return {
        "old": {"data": old_shape[0], "model": old_shape[1]},
        "new": {"data": data, "model": model},
        "chips_lost": old_shape[0] * old_shape[1] - data * model,
        "global_batch_scale": data / old_shape[0],
    }


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps whose duration is a z-score outlier vs. the EWMA."""

    alpha: float = 0.05          # EWMA smoothing
    z_threshold: float = 4.0
    patience: int = 3            # consecutive flags before escalation
    warmup_steps: int = 10

    _mean: float = 0.0
    _var: float = 0.0
    _n: int = 0
    _consecutive: int = 0
    flagged_steps: List[int] = dataclasses.field(default_factory=list)

    def observe(self, step: int, duration_s: float) -> bool:
        """Record a step duration; returns True if flagged as straggling."""
        self._n += 1
        if self._n <= self.warmup_steps:
            # Bootstrap statistics.
            delta = duration_s - self._mean
            self._mean += delta / self._n
            self._var += delta * (duration_s - self._mean)
            self._consecutive = 0
            return False
        std = max((self._var / max(self._n - 1, 1)) ** 0.5, 1e-9)
        z = (duration_s - self._mean) / std
        flagged = z > self.z_threshold
        if flagged:
            self.flagged_steps.append(step)
            self._consecutive += 1
        else:
            self._consecutive = 0
            # Only non-outliers update the EWMA (outliers would poison it).
            self._mean = (1 - self.alpha) * self._mean \
                + self.alpha * duration_s
        return flagged

    @property
    def should_escalate(self) -> bool:
        return self._consecutive >= self.patience


class StepTimer:
    def __init__(self):
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.monotonic() - self._t0
        return False
