"""repro_torch.obs — pluggable power sensing, metrics, and tracing (the
port of `repro.obs`).

* `sensors` — `PowerSensor` implementations (`SimulatedSensor` wrapping
  the analytical `Platform.power`, Jetson `SysfsRailsSensor`,
  `NVMLSensor` bound to the NVIDIA driver's NVML with ctypes,
  deterministic `ReplaySensor` / `RecordingSensor` JSONL traces,
  `FallbackSensor` chains) and `make_sensor("replay:<path>")`-style spec
  parsing.
* `meter` — `EnergyMeter`: background sampling at a configurable rate,
  trapezoidal integration, `measure()` context manager returning
  joules / avg watts / peak watts.
* `metrics` — counters, gauges, histograms in a `MetricsRegistry`.
* `tracing` — span/event emitter with a JSONL exporter and the
  process-wide observation session (`observing(path)`; a no-op when no
  session is open).

Stdlib only at import time: the controller, platform, and serving layers
all emit through this package, so it must never import them back.
"""

from repro_torch.obs.meter import EnergyMeter, Measurement
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.sensors import (FallbackSensor, NVMLSensor, PowerSensor,
                                     RecordingSensor, ReplaySensor,
                                     SensorUnavailable, SimulatedSensor,
                                     SysfsRailsSensor, autodetect_sensor,
                                     make_sensor)
from repro_torch.obs.tracing import (ObsSession, active, emit, observing,
                                     session, set_session)

__all__ = [
    "EnergyMeter", "Measurement",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "FallbackSensor", "NVMLSensor", "PowerSensor", "RecordingSensor",
    "ReplaySensor", "SensorUnavailable", "SimulatedSensor",
    "SysfsRailsSensor", "autodetect_sensor", "make_sensor",
    "ObsSession", "active", "emit", "observing", "session", "set_session",
]
