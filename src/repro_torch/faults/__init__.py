"""Fault injection and graceful degradation of the port (a copy of
`repro.faults`, framework-free: plain numpy and the port's own tracing,
sensors and dispatcher).

Edge serving's routine failures — sensor dropouts and NaN spikes, device
crashes and thermal throttling, hung stragglers, clients abandoning
requests — as a seeded, replayable schedule (`FaultPlan`,
``--faults <spec>``) plus the injector wrappers that thread it through
every serving seam (`FlakySensor`, `FaultyFleet`,
`apply_request_faults`).  The degradation half lives where the seams
are: `platform.base.AsyncDispatcher` (deadlines, retries, quarantine),
`obs.sensors.FallbackSensor` / `obs.meter` (sensor chains, per-sample
error counting), `core.controller` (censored `FailedPull` records), and
`serving.scheduler` / `serving.engine` (request cancellation).

The spec grammar and the event reference are the reference's
(docs/RESILIENCE.md); a plan's decisions are the reference's bit for bit.
"""

from repro_torch.faults.injectors import (FaultyFleet, FlakySensor,
                                          apply_request_faults,
                                          nominal_duration, wrap_env,
                                          wrap_sensor)
from repro_torch.faults.plan import FaultPlan, parse_faults

__all__ = ["FaultPlan", "FaultyFleet", "FlakySensor",
           "apply_request_faults", "nominal_duration", "parse_faults",
           "wrap_env", "wrap_sensor"]
