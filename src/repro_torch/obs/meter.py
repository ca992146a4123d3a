"""Energy metering: integrate a `PowerSensor` over a measured interval.

`EnergyMeter.measure()` is the one way this repo turns instantaneous
power readings into joules: it samples the sensor on a background thread
at a configurable rate (plus guaranteed samples at entry and exit, so
even a zero-duration measurement has a defined power), and integrates
the (t, watts) samples trapezoidally on exit.

Exactness contract (what keeps default runs bit-identical)
----------------------------------------------------------
When every sample of a measurement reads the same value w — the
`SimulatedSensor` case, whose analytical reading only changes on
actuation — the trapezoid degenerates and the meter reports
``avg_watts == w`` *exactly* (the very float the platform model
returned) rather than reconstructing it as ``joules / duration`` with
accumulated rounding.  `EngineEnvironment` therefore produces
bit-identical observations whether it evaluates `Platform.power`
directly or meters a `SimulatedSensor`, which is asserted in
tests/test_torch_obs.py.

For genuinely varying signals (rails, NVML, replayed traces) the
trapezoid is exact for piecewise-linear power and second-order accurate
otherwise; the accuracy-vs-closed-form test drives it with ramps.

Fault tolerance: a `read_watts()` that raises, or returns a non-finite
value (NaN spikes from flaky rails), does not kill the sampler thread or
poison the integral — the sample is dropped and counted in
`Measurement.sample_errors` (surfaced by `summary()`), and sampling
continues.  A measurement whose every sample failed finalizes to zeros
rather than crashing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import List, Optional


@dataclasses.dataclass
class Measurement:
    """One metering interval.  `sample()` may be called manually (the
    meter's background thread does the same); the summary fields are
    populated when the `measure()` context exits."""

    sensor_name: str
    times: List[float] = dataclasses.field(default_factory=list)
    watts: List[float] = dataclasses.field(default_factory=list)
    joules: float = 0.0
    avg_watts: float = 0.0
    peak_watts: float = 0.0
    duration_s: float = 0.0
    sample_errors: int = 0
    _clock: object = time.monotonic
    _sensor: object = None
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)

    @property
    def n_samples(self) -> int:
        return len(self.times)

    def sample(self) -> Optional[float]:
        """Read the sensor once and append the (t, w) point.  A read that
        raises or returns a non-finite value is dropped and counted in
        `sample_errors` (returns None) — one bad read must not kill the
        background sampler thread or poison the integral."""
        try:
            w = float(self._sensor.read_watts())
        except Exception:  # noqa: BLE001 - any sensor failure degrades
            with self._lock:
                self.sample_errors += 1
            return None
        if not math.isfinite(w):
            with self._lock:
                self.sample_errors += 1
            return None
        with self._lock:
            self.times.append(float(self._clock()))
            self.watts.append(w)
        return w

    def _finalize(self) -> None:
        t, w = self.times, self.watts
        if not t:
            # Every sample failed: nothing to integrate; the zeros plus
            # a non-zero sample_errors tell the story in summary().
            return
        self.duration_s = t[-1] - t[0]
        self.peak_watts = max(w)
        if min(w) == self.peak_watts:
            # Constant signal: report the sensor's exact value (see the
            # module docstring's exactness contract).
            self.avg_watts = w[0]
            self.joules = w[0] * self.duration_s
            return
        j = 0.0
        for i in range(1, len(t)):
            j += 0.5 * (w[i - 1] + w[i]) * (t[i] - t[i - 1])
        self.joules = j
        self.avg_watts = j / self.duration_s if self.duration_s > 0 else w[0]

    def summary(self) -> dict:
        return {"sensor": self.sensor_name, "joules": self.joules,
                "avg_watts": self.avg_watts, "peak_watts": self.peak_watts,
                "duration_s": self.duration_s, "n_samples": self.n_samples,
                "sample_errors": self.sample_errors}


class EnergyMeter:
    """Background power sampler over one `PowerSensor`.

    `hz` sets the background sampling rate; `background=False` disables
    the thread entirely (samples then come only from entry/exit and
    manual `Measurement.sample()` calls — what the deterministic tests
    use, together with an injected `clock`)."""

    def __init__(self, sensor, hz: float = 20.0, clock=time.monotonic,
                 background: bool = True):
        if hz <= 0:
            raise ValueError(f"sampling rate must be > 0 Hz, got {hz}")
        self.sensor = sensor
        self.hz = float(hz)
        self.clock = clock
        self.background = bool(background)

    @contextlib.contextmanager
    def measure(self):
        """Measure the enclosed interval; yields the live `Measurement`
        (joules/avg/peak are final once the context exits)."""
        m = Measurement(sensor_name=getattr(self.sensor, "name",
                                            type(self.sensor).__name__),
                        _clock=self.clock, _sensor=self.sensor)
        m.sample()
        stop: Optional[threading.Event] = None
        worker: Optional[threading.Thread] = None
        if self.background:
            stop = threading.Event()
            period = 1.0 / self.hz

            def _run():
                while not stop.wait(period):
                    m.sample()

            worker = threading.Thread(target=_run, name="energy-meter",
                                      daemon=True)
            worker.start()
        try:
            yield m
        finally:
            if worker is not None:
                stop.set()
                worker.join()
            m.sample()
            m._finalize()
