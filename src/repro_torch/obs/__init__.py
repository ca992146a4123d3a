"""repro_torch.obs — metrics and tracing (copies of `repro.obs.metrics`
and `repro.obs.tracing`).  Power sensors and the energy meter are not
ported yet: the engine path evaluates the analytical board model."""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.tracing import (ObsSession, active, emit, observing,
                                     session, set_session)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "ObsSession", "active", "emit", "observing", "session", "set_session",
]
