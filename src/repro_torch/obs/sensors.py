"""Pluggable power sensors behind the `Platform.power` contract.

The paper measures energy on a Jetson AGX Orin's on-board INA3221 power
rails; this repo's environments historically derived every joule from the
analytical board model.  `PowerSensor` pins the seam between the two: a
sensor is anything that answers "how many watts is the device drawing
right now?", and the `EnergyMeter` (meter.py) integrates those readings
into joules for an arm pull.

Sensor matrix (see docs/TELEMETRY.md):

* `SimulatedSensor`  — wraps the existing analytical `Platform.power`
  at the platform's currently actuated level; constant between level
  changes, so metering it reproduces the analytical energy bit-for-bit.
* `SysfsRailsSensor` — Jetson INA3221 rails via the sysfs/hwmon hotplug
  paths (mW under iio, uW under hwmon); sums all discovered rails.
* `NVMLSensor`       — NVIDIA board power through NVML (mW), for dGPU
  hosts, bound with ctypes to the NVIDIA driver's `libnvidia-ml.so.1` (no
  pynvml); raises `SensorUnavailable` when the library, its init or
  the device is missing.
* `ReplaySensor`     — replays a JSONL power trace deterministically
  (each read returns the next sample), so hardware-captured traces run
  in CI without hardware.
* `RecordingSensor`  — wraps any sensor and appends every reading to a
  JSONL trace; `ReplaySensor(path)` of that file replays the identical
  watt sequence (round-trip tested).
* `FallbackSensor`   — an ordered chain of sensors; a mid-run
  `read_watts` failure degrades to the next sensor (one `fault.sensor`
  event per hop) instead of killing the measurement.

Trace row schema (shared by Replay/Recording): one JSON object per line,
``{"t": <seconds since recording start>, "watts": <float>}``.

Specs: `make_sensor("simulated" | "sysfs" | "nvml" | "replay:<path>" |
"record:<path>" | "fallback:<spec>,<spec>,...")` builds a sensor from
the CLI spelling (`serve.py --sensor ...`).  Hardware sensors raise
`SensorUnavailable` — not ImportError — when their backing is missing,
so callers can fall back or fail with a clear message; nothing here
imports heavy dependencies at module import time.

Degradation semantics (tested in tests/test_torch_obs.py):

* Trace exhaustion: a non-looping `ReplaySensor` that runs out of
  samples *holds its final value* — `read_watts` keeps returning the
  last recorded watts, sets `exhausted`, and emits one ``fault.sensor``
  warning event (reason ``trace-exhausted``) on the first held read.  It
  never raises mid-meter: a run that outlives its trace degrades to a
  constant tail instead of dying inside the sampler thread.
* Fallback chains: ``fallback:nvml,sysfs,simulated`` tries each spec in
  order at construction (unavailable backends are skipped with a
  ``fault.sensor`` event; all-unavailable raises `SensorUnavailable`),
  then serves reads from the first live sensor.  A read that *raises*
  degrades permanently to the next sensor in the chain (no flap-back);
  when the last sensor fails, `SensorUnavailable` propagates.  NaN
  readings are not a failure here — the `EnergyMeter` rejects
  non-finite samples itself (`sample_errors`).
"""

from __future__ import annotations

import ctypes
import glob
import json
import time
from typing import IO, List, Optional, Protocol, Sequence, Union, \
    runtime_checkable

from repro_torch.obs import tracing as obslog


class SensorUnavailable(RuntimeError):
    """The sensor's backing (sysfs rails, NVML, a trace file) is absent."""


@runtime_checkable
class PowerSensor(Protocol):
    """Instantaneous device power, in watts."""

    @property
    def name(self) -> str: ...

    def read_watts(self) -> float: ...

    def close(self) -> None: ...


class SimulatedSensor:
    """The analytical board model as a sensor: reads
    ``platform.power(platform.current_level, utilization)``.

    The reading is piecewise-constant — it only changes when the platform
    is actuated (`set_level`) or the workload utilization is updated
    (`set_utilization`, which environments call per pull from their
    batch-size → utilization model).  The `EnergyMeter` integrates
    constant signals exactly, so a simulated-sensor measurement is
    bit-identical to evaluating `Platform.power` analytically — the
    property that makes `--sensor simulated` safe to thread through every
    serving path by default.
    """

    def __init__(self, platform, utilization: float = 1.0):
        if platform is None:
            raise SensorUnavailable(
                "SimulatedSensor needs a Platform to wrap (its reading IS "
                "Platform.power); pass the environment's platform")
        self.platform = platform
        self.utilization = float(utilization)

    @property
    def name(self) -> str:
        return f"simulated:{self.platform.name}"

    def set_utilization(self, utilization: float) -> None:
        self.utilization = float(utilization)

    def read_watts(self) -> float:
        return float(self.platform.power(self.platform.current_level,
                                         self.utilization))

    def close(self) -> None:
        pass


#: Where Jetson power rails surface, in discovery order.  The INA3221's
#: iio nodes report milliwatts; generic hwmon power files report
#: microwatts — `SysfsRailsSensor` scales by path.
SYSFS_RAIL_GLOBS = (
    # Jetson (L4T <= r32): INA3221 behind the iio subsystem, mW.
    "/sys/bus/i2c/drivers/ina3221x/*/iio:device*/in_power*_input",
    "/sys/bus/i2c/drivers/ina3221x/*/iio_device/in_power*_input",
    # Jetson (L4T >= r34) and mainline: INA3221 as a hwmon chip, uW.
    "/sys/bus/i2c/drivers/ina3221/*/hwmon/hwmon*/power*_input",
)


class SysfsRailsSensor:
    """Sum of the board's power rails read from sysfs (Jetson INA3221).

    `paths` overrides discovery (tests point it at a tmpdir); by default
    the Jetson hotplug globs above are scanned and the sensor raises
    `SensorUnavailable` when no rail file exists (non-Jetson hosts).
    Rail files under an ``iio`` node are milliwatts, under ``hwmon``
    microwatts; a missing or transiently unreadable rail reads as 0 W
    (rails hotplug on carrier boards) rather than failing a measurement.
    """

    def __init__(self, paths: Optional[Sequence[str]] = None):
        if paths is None:
            paths = [p for g in SYSFS_RAIL_GLOBS for p in sorted(glob.glob(g))]
        self.paths: List[str] = list(paths)
        if not self.paths:
            raise SensorUnavailable(
                "no INA3221 power-rail files found under "
                f"{SYSFS_RAIL_GLOBS}; is this a Jetson? (pass paths= to "
                "override discovery)")

    @property
    def name(self) -> str:
        return f"sysfs:{len(self.paths)}rails"

    @staticmethod
    def _scale(path: str) -> float:
        return 1e-6 if "hwmon" in path else 1e-3

    def read_watts(self) -> float:
        total = 0.0
        for p in self.paths:
            try:
                with open(p) as f:
                    total += float(f.read().strip()) * self._scale(p)
            except (OSError, ValueError):
                continue
        return total

    def close(self) -> None:
        pass


#: The NVML library the NVIDIA driver installs.
NVML_LIBRARY = "libnvidia-ml.so.1"
#: Bytes of the buffer `nvmlDeviceGetUUID` fills
#: (NVML_DEVICE_UUID_V2_BUFFER_SIZE).
_NVML_UUID_BYTES = 96


def _load_nvml():
    """The NVML library with the prototypes this module calls, or
    `SensorUnavailable` when the NVIDIA driver's library is not installed."""
    try:
        lib = ctypes.CDLL(NVML_LIBRARY)
    except OSError as e:
        raise SensorUnavailable(
            f"NVMLSensor needs {NVML_LIBRARY} (the NVIDIA driver's NVML), "
            f"which cannot be loaded: {e}; use --sensor simulated, sysfs, "
            "or replay:<path>") from None
    handle_p = ctypes.POINTER(ctypes.c_void_p)
    for name, argtypes in (
            ("nvmlInit_v2", []),
            ("nvmlShutdown", []),
            ("nvmlDeviceGetHandleByIndex_v2", [ctypes.c_uint, handle_p]),
            ("nvmlDeviceGetPowerUsage",
             [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)]),
            ("nvmlDeviceGetUUID",
             [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.nvmlErrorString.argtypes = [ctypes.c_int]
    lib.nvmlErrorString.restype = ctypes.c_char_p
    return lib


class NVMLSensor:
    """NVIDIA board power draw via NVML (`nvmlDeviceGetPowerUsage`, mW).

    Binds the NVIDIA driver's NVML library with ctypes when constructed (never
    at import) and raises `SensorUnavailable` when the library is absent,
    `nvmlInit_v2` fails or there is no device at `index`.  `index` is
    NVML's device index, which need not be CUDA's under
    CUDA_VISIBLE_DEVICES: `uuid()` names the board read.  `lib` and
    `handle` are the bound library and the device handle.
    """

    def __init__(self, index: int = 0):
        lib = _load_nvml()
        _nvml_check(lib, lib.nvmlInit_v2(), "NVML init")
        handle = ctypes.c_void_p()
        try:
            _nvml_check(lib, lib.nvmlDeviceGetHandleByIndex_v2(
                int(index), ctypes.byref(handle)), f"NVML device {index}")
        except SensorUnavailable:
            lib.nvmlShutdown()
            raise
        self.lib, self.handle = lib, handle
        self.index = int(index)

    @property
    def name(self) -> str:
        return f"nvml:{self.index}"

    def read_watts(self) -> float:
        mw = ctypes.c_uint()
        _nvml_check(self.lib, self.lib.nvmlDeviceGetPowerUsage(
            self.handle, ctypes.byref(mw)), "nvmlDeviceGetPowerUsage")
        return mw.value / 1000.0

    def uuid(self) -> str:
        """The board's UUID as NVML gives it ("GPU-<hex groups>")."""
        buf = ctypes.create_string_buffer(_NVML_UUID_BYTES)
        _nvml_check(self.lib, self.lib.nvmlDeviceGetUUID(
            self.handle, buf, _NVML_UUID_BYTES), "nvmlDeviceGetUUID")
        return buf.value.decode()

    def close(self) -> None:
        self.lib.nvmlShutdown()


def _nvml_check(lib, rc: int, what: str) -> None:
    """Raise `SensorUnavailable` with NVML's message when `rc` is not
    NVML_SUCCESS (0)."""
    if rc != 0:
        msg = lib.nvmlErrorString(rc)
        raise SensorUnavailable(
            f"{what} failed: {msg.decode() if msg else f'NVML error {rc}'}")


class ReplaySensor:
    """Deterministic playback of a recorded power trace.

    Each `read_watts()` returns the next sample's watts, in file order —
    call-indexed, not wall-clock-indexed, so a trace replays identically
    however fast the meter samples it.  Past the end the trace wraps
    (`loop=True`, the default: a short rails capture can power an
    arbitrarily long CI run) or holds the final sample (`loop=False`).

    Exhaustion contract (`loop=False`, tested): the sensor never raises
    when the trace runs out — it keeps returning the final sample (a
    constant tail), sets `exhausted = True`, and emits one
    ``fault.sensor`` warning event (reason ``trace-exhausted``) on the
    first held read so the degradation is visible in the trace rather
    than an opaque exception inside the meter's sampler thread.
    """

    def __init__(self, source: Union[str, IO[str]], loop: bool = True):
        if isinstance(source, str):
            self._label = source
            try:
                with open(source) as f:
                    lines = f.readlines()
            except OSError as e:
                raise SensorUnavailable(
                    f"cannot read power trace {source!r}: {e}") from None
        else:
            self._label = getattr(source, "name", "<stream>")
            lines = source.readlines()
        self.samples: List[float] = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            self.samples.append(float(row["watts"]))
        if not self.samples:
            raise SensorUnavailable(
                f"power trace {self._label!r} contains no samples")
        self.loop = bool(loop)
        self._i = 0
        self.exhausted = False

    @property
    def name(self) -> str:
        return f"replay:{self._label}"

    def read_watts(self) -> float:
        if self._i >= len(self.samples):
            if self.loop:
                self._i = 0
            else:
                if not self.exhausted:
                    self.exhausted = True
                    if obslog.active():
                        obslog.emit("fault.sensor", sensor=self.name,
                                    reason="trace-exhausted",
                                    held_watts=self.samples[-1],
                                    n_samples=len(self.samples))
                return self.samples[-1]
        w = self.samples[self._i]
        self._i += 1
        return w

    def close(self) -> None:
        pass


class RecordingSensor:
    """Wrap a sensor; append every reading to a JSONL trace.

    Captures hardware runs for deterministic CI replay: the recorded
    file's watt sequence is exactly what `ReplaySensor` will return,
    reading for reading (round-trip tested in tests/test_torch_obs.py).
    """

    def __init__(self, inner, path: Union[str, IO[str]],
                 clock=time.monotonic):
        self.inner = inner
        self._own_sink = isinstance(path, str)
        self._sink = open(path, "w") if self._own_sink else path
        self._clock = clock
        self._t0 = clock()

    @property
    def name(self) -> str:
        return f"record({self.inner.name})"

    def set_utilization(self, utilization: float) -> None:
        fn = getattr(self.inner, "set_utilization", None)
        if fn is not None:
            fn(utilization)

    def read_watts(self) -> float:
        w = float(self.inner.read_watts())
        self._sink.write(json.dumps(
            {"t": round(self._clock() - self._t0, 9), "watts": w}) + "\n")
        return w

    def close(self) -> None:
        self._sink.flush()
        if self._own_sink:
            self._sink.close()
        self.inner.close()


class FallbackSensor:
    """An ordered chain of sensors with mid-run degradation.

    Reads are served by the first live sensor in the chain; a read that
    raises (hardware unplugged, NVML gone, rails unreadable) emits a
    ``fault.sensor`` event and degrades *permanently* to the next sensor
    — metering continues on the fallback instead of dying.  When the
    last sensor fails, `SensorUnavailable` propagates (the meter then
    counts the failed samples, see `EnergyMeter`).

    Build from specs via ``make_sensor("fallback:nvml,sysfs,simulated")``
    — specs whose backing is absent at construction are skipped (with a
    ``fault.sensor`` event); all-absent raises `SensorUnavailable`.
    `set_utilization` fans out to every chain member that accepts it, so
    degrading to a `SimulatedSensor` picks up the current workload.
    """

    def __init__(self, sensors: Sequence):
        self._chain = list(sensors)
        if not self._chain:
            raise SensorUnavailable("FallbackSensor needs >= 1 sensor")
        self._i = 0
        self.degradations = 0

    @classmethod
    def from_specs(cls, specs: Sequence[str], platform=None
                   ) -> "FallbackSensor":
        chain, dead = [], []
        for spec in specs:
            spec = spec.strip()
            if not spec:
                continue
            try:
                chain.append(make_sensor(spec, platform))
            except SensorUnavailable as e:
                dead.append(f"{spec}: {e}")
                if obslog.active():
                    obslog.emit("fault.sensor", sensor=spec,
                                phase="construct", reason=str(e))
        if not chain:
            raise SensorUnavailable(
                "no sensor in the fallback chain is available: "
                + "; ".join(dead))
        return cls(chain)

    @property
    def current(self):
        return self._chain[self._i]

    @property
    def name(self) -> str:
        return f"fallback:{self.current.name}"

    def set_utilization(self, utilization: float) -> None:
        for s in self._chain:
            fn = getattr(s, "set_utilization", None)
            if fn is not None:
                fn(utilization)

    def read_watts(self) -> float:
        while True:
            s = self._chain[self._i]
            try:
                return float(s.read_watts())
            except Exception as e:  # noqa: BLE001 - any backend failure
                if self._i + 1 >= len(self._chain):
                    raise SensorUnavailable(
                        f"fallback chain exhausted; last sensor "
                        f"{s.name!r} failed: {e}") from e
                self.degradations += 1
                self._i += 1
                if obslog.active():
                    obslog.emit("fault.sensor", sensor=s.name,
                                reason=f"read failed: {e}",
                                degraded_to=self._chain[self._i].name)
                try:
                    s.close()
                except Exception:  # noqa: BLE001 - already degraded
                    pass

    def close(self) -> None:
        for s in self._chain[self._i:]:
            try:
                s.close()
            except Exception:  # noqa: BLE001 - close best-effort
                pass


def autodetect_sensor(platform=None):
    """Best available real sensor, falling back to the analytical model:
    sysfs rails, then NVML, then `SimulatedSensor(platform)` (which
    raises `SensorUnavailable` when no platform is given either)."""
    for cls in (SysfsRailsSensor, NVMLSensor):
        try:
            return cls()
        except SensorUnavailable:
            continue
    return SimulatedSensor(platform)


def make_sensor(spec, platform=None):
    """Build a sensor from its CLI spelling (`serve.py --sensor ...`):

        simulated            analytical Platform.power (needs `platform`)
        sysfs                Jetson INA3221 rails
        nvml                 NVIDIA NVML board power
        replay:<path>        deterministic JSONL trace playback
        record:<path>        autodetected sensor, recorded to <path>
        fallback:<s>,<s>,..  ordered degradation chain of the above

    A `PowerSensor` instance passes through unchanged, so APIs can accept
    either a spec string or a ready sensor.
    """
    if not isinstance(spec, str):
        return spec
    if spec.startswith("fallback:"):
        return FallbackSensor.from_specs(
            spec[len("fallback:"):].split(","), platform)
    if spec == "simulated":
        return SimulatedSensor(platform)
    if spec == "sysfs":
        return SysfsRailsSensor()
    if spec == "nvml":
        return NVMLSensor()
    if spec.startswith("replay:"):
        return ReplaySensor(spec[len("replay:"):])
    if spec.startswith("record:"):
        return RecordingSensor(autodetect_sensor(platform),
                               spec[len("record:"):])
    raise ValueError(
        f"unknown sensor spec {spec!r}; expected simulated, sysfs, nvml, "
        f"replay:<path>, or record:<path>")
