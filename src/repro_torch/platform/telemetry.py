"""Backend-agnostic serving telemetry.

Two things every Camel backend shares, factored out of the four previously
copy-pasted implementations (analytical Jetson, event-driven, TPU
landscape/elastic, real engine):

* `Observation` — the full record of one arm pull.  Environments return it
  from `pull`; the controller records it per round and summarizes it.  It
  unpacks as an ``(energy, latency)`` pair, so code written against the old
  bare-tuple contract keeps working.

* `queueing_latency` — the single queueing-latency model (paper Eq. 7 plus
  the saturation backlog; see serving/energy.py for the derivation):

      latency     = queue_wait + batch_time + backlog
      queue_wait  = (b - 1) / (2 lambda)
      backlog     = max(0, batch_time / n_servers - b / lambda) * (J - 1) / 2

  with J = ceil(n_requests / b) batches over the measurement horizon and
  `n_servers` parallel servers draining the queue (the TPU elastic
  slice-width knob; 1 everywhere else).

This module is import-light on purpose (numpy + stdlib only): both
`serving.energy` and `core.priors` depend on it, so it must not import
anything from `repro_torch.serving` or `repro_torch.core`.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Queueing-latency model (the one shared copy of the wait+backlog formula)
# ---------------------------------------------------------------------------


def _check_arrival_rate(arrival_rate: float) -> None:
    # lambda <= 0 means "requests never arrive": the accumulation wait is
    # undefined (division by zero) or negative, which would silently poison
    # every latency/cost downstream.  Fail at the seam with a clear message.
    # Mirrors serving.queueing.require_positive_rate — the environments'
    # constructor-time guard — which this layer cannot import (platform
    # must stay below serving in the dependency order).
    if arrival_rate <= 0:
        raise ValueError(
            f"arrival_rate must be positive (requests/s), got "
            f"{arrival_rate!r}; the queueing model divides by lambda")


def queue_wait(batch: int, arrival_rate: float) -> float:
    """Mean in-queue wait while a batch of `batch` accumulates at rate
    lambda (paper Eq. 7 first term): (b - 1) / (2 lambda)."""
    _check_arrival_rate(arrival_rate)
    return (batch - 1) / (2.0 * arrival_rate)


def saturation_backlog(batch_time_s: float, batch: int, arrival_rate: float,
                       n_requests: int, n_servers: float = 1.0) -> float:
    """Mean extra latency from queue growth when service is slower than
    arrivals, over a finite horizon of ceil(n_requests / b) batches."""
    _check_arrival_rate(arrival_rate)
    n_batches = int(np.ceil(n_requests / batch))
    return max(0.0, batch_time_s / n_servers - batch / arrival_rate) \
        * (n_batches - 1) / 2.0


@dataclasses.dataclass(frozen=True)
class QueueingLatency:
    """Decomposed mean request latency: wait + batch_time + backlog."""

    wait: float
    batch_time: float
    backlog: float

    @property
    def total(self) -> float:
        return self.wait + self.batch_time + self.backlog


def queueing_latency(batch_time_s: float, batch: int, arrival_rate: float,
                     n_requests: int = 1, n_servers: float = 1.0,
                     ) -> QueueingLatency:
    """The shared latency model.  `n_requests=1` (or any value <= batch)
    yields a single-batch horizon with zero backlog — what a live engine
    measurement uses."""
    return QueueingLatency(
        wait=queue_wait(batch, arrival_rate),
        batch_time=batch_time_s,
        backlog=saturation_backlog(batch_time_s, batch, arrival_rate,
                                   n_requests, n_servers))


# ---------------------------------------------------------------------------
# Observation
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Observation:
    """Everything one arm pull observed.

    `energy` (J/request) and `latency` (s/request) drive the cost model;
    the remaining fields are telemetry for diagnostics, richer summaries
    and future async/sharded controllers.  Unpacks as (energy, latency).
    """

    energy: float                 # J / request
    latency: float                # s / request = wait + batch_time + backlog
    batch_time: float = 0.0       # s, service time of one batch
    queue_wait: float = 0.0       # s, accumulation wait
    backlog: float = 0.0          # s, saturation-induced queue growth
    power: float = 0.0            # W, mean platform power during the batch
    batch: int = 0                # requests per batch at this arm
    tokens: int = 0               # tokens generated for this observation
    metadata: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def __iter__(self):
        """Tuple-compatibility: ``e, l = obs`` keeps working."""
        yield self.energy
        yield self.latency

    @property
    def edp(self) -> float:
        return self.energy * self.latency

    def scaled(self, energy_factor: float = 1.0, latency_factor: float = 1.0
               ) -> "Observation":
        """Observation-noise application (multiplicative, as the simulators
        model it).  Telemetry fields stay at their expected values."""
        return dataclasses.replace(self,
                                   energy=self.energy * energy_factor,
                                   latency=self.latency * latency_factor)

    @staticmethod
    def of(value) -> "Observation":
        """Coerce a legacy ``(energy, latency)`` pair (or an Observation)
        to an Observation."""
        if isinstance(value, Observation):
            return value
        e, l = value
        return Observation(energy=float(e), latency=float(l))


def observe(power_w: float, batch_time_s: float, batch: int,
            arrival_rate: float, n_requests: int = 1,
            n_servers: float = 1.0, tokens: int = 0,
            metadata: Mapping[str, object] = None) -> Observation:
    """Build a full Observation from batch-level power/time plus the shared
    queueing model.  Energy per request is Eq. 5: P * t_batch / b (per
    server; `power_w` is the total across `n_servers`)."""
    q = queueing_latency(batch_time_s, batch, arrival_rate, n_requests,
                         n_servers)
    return Observation(
        energy=power_w * batch_time_s / (batch * n_servers),
        latency=q.total,
        batch_time=batch_time_s,
        queue_wait=q.wait,
        backlog=q.backlog,
        power=power_w,
        batch=int(batch),
        tokens=int(tokens),
        metadata=dict(metadata or {}))
