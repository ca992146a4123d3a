"""The port's power sensors and energy meter (`repro_torch.obs`), on the
CPU: tests/test_obs.py's sensor and meter cases restated against the
port, and the cross-framework checks.

- Replay and record round trip, on `tests/data/rails_small.jsonl` too;
  sysfs rail scaling on tmp files; `make_sensor` specs; the trapezoid
  exact on a ramp and on a constant; sample errors counted; replay
  exhaustion and the fallback chain.
- The same replay trace through the port's `EnergyMeter` and the
  reference's (`background=False`, one injected clock) gives identical
  joules, average and peak watts.
- The port's `EngineEnvironment` with `sensor="simulated"` gives
  bit-identical observations to `sensor=None`, for both schedulers.
- `NVMLSensor()` raises `SensorUnavailable` where the NVIDIA driver's
  `libnvidia-ml.so.1` cannot be loaded (this host has none).
- A `serve.py --metrics-out` trace of the port renders with
  `tools/trace_report.py`.

The card's side (finite NVML watts within the power limit) is in
tests/test_torch_cuda.py.
"""

import ctypes
import io
import json
import math
import os
import sys
import time
import types

import numpy as np
import pytest

from repro import obs as ref_obs
from repro_torch import obs
from repro_torch.obs import sensors as sensors_mod
from repro_torch.platform.base import DVFSPlatform
from repro_torch.serving import energy
from repro_torch.serving.engine import (ContinuousStats, EngineEnvironment,
                                        EngineStats)
from repro_torch.serving.scheduler import RequestRecord

DATA_TRACE = os.path.join(os.path.dirname(__file__), "data",
                          "rails_small.jsonl")
TOOLS = os.path.join(os.path.dirname(__file__), "..", "tools")


class _SeqSensor:
    """Emits a fixed watt sequence, then holds the last value."""

    name = "seq"

    def __init__(self, seq):
        self.seq = list(seq)
        self.i = 0
        self.closed = False

    def read_watts(self):
        w = self.seq[min(self.i, len(self.seq) - 1)]
        self.i += 1
        return w

    def close(self):
        self.closed = True


class _FaultySensor:
    """Reads a constant, but fails (raise or NaN) on scripted indices."""

    name = "faulty"

    def __init__(self, watts=9.0, raise_at=(), nan_at=()):
        self.watts = watts
        self.raise_at = set(raise_at)
        self.nan_at = set(nan_at)
        self.i = -1

    def read_watts(self):
        self.i += 1
        if self.i in self.raise_at:
            raise obs.SensorUnavailable(f"scripted failure at {self.i}")
        if self.i in self.nan_at:
            return float("nan")
        return self.watts

    def close(self):
        pass


class _Bench:
    """Deterministic (clock, sensor) pair: the sensor reads f(t) at the
    clock's current time; the test advances time between samples."""

    def __init__(self, f):
        self.t = 0.0
        self.f = f

    def clock(self):
        return self.t

    @property
    def sensor(self):
        bench = self

        class _S:
            name = "bench"

            def read_watts(self):
                return bench.f(bench.t)

            def close(self):
                pass

        return _S()


def _rows(sink):
    return [json.loads(line) for line in sink.getvalue().splitlines()]


# ---------------------------------------------------------------------------
# Sensors
# ---------------------------------------------------------------------------


def test_recording_replay_round_trip(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    seq = [2.0, 5.0, 8.0, 11.0, 14.0]
    rec = obs.RecordingSensor(_SeqSensor(seq), path)
    assert [rec.read_watts() for _ in seq] == seq
    rec.close()
    assert rec.inner.closed
    rep = obs.ReplaySensor(path)
    assert [rep.read_watts() for _ in seq] == seq
    with open(path) as f:
        ts = [json.loads(line)["t"] for line in f]
    assert ts == sorted(ts) and len(ts) == len(seq)


def test_recording_replay_round_trip_of_the_rails_trace(tmp_path):
    """Recording a replay of the checked-in rails trace and replaying the
    recording gives the same 50 readings, in order."""
    path = str(tmp_path / "again.jsonl")
    rec = obs.RecordingSensor(obs.ReplaySensor(DATA_TRACE), path)
    first = [rec.read_watts() for _ in range(50)]
    rec.close()
    assert first == obs.ReplaySensor(DATA_TRACE).samples
    rep = obs.ReplaySensor(path)
    assert [rep.read_watts() for _ in range(50)] == first


def test_replay_sensor_loop_and_hold():
    src = io.StringIO('{"t": 0, "watts": 1.0}\n{"t": 1, "watts": 2.0}\n')
    looping = obs.ReplaySensor(src)
    assert [looping.read_watts() for _ in range(5)] == [1, 2, 1, 2, 1]
    src.seek(0)
    holding = obs.ReplaySensor(src, loop=False)
    assert [holding.read_watts() for _ in range(4)] == [1, 2, 2, 2]


def test_replay_sensor_reads_checked_in_rails_trace():
    rep = obs.ReplaySensor(DATA_TRACE)
    assert len(rep.samples) == 50
    assert rep.read_watts() == 12.0
    assert all(5.0 < w < 25.0 for w in rep.samples)


def test_replay_sensor_missing_or_empty_trace(tmp_path):
    with pytest.raises(obs.SensorUnavailable, match="cannot read"):
        obs.ReplaySensor(str(tmp_path / "nope.jsonl"))
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    with pytest.raises(obs.SensorUnavailable, match="no samples"):
        obs.ReplaySensor(str(empty))


def test_sysfs_rails_scaling_and_resilience(tmp_path):
    iio = tmp_path / "iio"
    hwmon = tmp_path / "hwmon"
    iio.mkdir(), hwmon.mkdir()
    rail_mw = iio / "in_power0_input"
    rail_mw.write_text("12000\n")            # iio path: mW -> 12 W
    rail_uw = hwmon / "power1_input"
    rail_uw.write_text("15000000\n")         # hwmon path: uW -> 15 W
    gone = tmp_path / "unplugged" / "power2_input"   # never created
    s = obs.SysfsRailsSensor(paths=[str(rail_mw), str(rail_uw), str(gone)])
    assert s.read_watts() == pytest.approx(27.0)
    assert s.name == "sysfs:3rails"
    with pytest.raises(obs.SensorUnavailable):
        obs.SysfsRailsSensor(paths=[])


def test_simulated_sensor_tracks_platform_actuation():
    plat = DVFSPlatform(energy.JETSON_AGX_ORIN)
    s = obs.SimulatedSensor(plat, utilization=0.5)
    w0 = s.read_watts()
    assert w0 == float(plat.power(plat.current_level, 0.5))
    plat.set_level(plat.n_levels - 1)
    s.set_utilization(1.0)
    assert s.read_watts() == float(plat.power(plat.n_levels - 1, 1.0))
    assert s.read_watts() > w0


def test_make_sensor_specs(tmp_path):
    plat = DVFSPlatform(energy.JETSON_AGX_ORIN)
    assert isinstance(obs.make_sensor("simulated", platform=plat),
                      obs.SimulatedSensor)
    with pytest.raises(obs.SensorUnavailable, match="Platform"):
        obs.make_sensor("simulated")
    rep = obs.make_sensor(f"replay:{DATA_TRACE}")
    assert isinstance(rep, obs.ReplaySensor)
    assert obs.make_sensor(rep) is rep
    rec = obs.make_sensor(f"record:{tmp_path / 'out.jsonl'}", platform=plat)
    assert isinstance(rec, obs.RecordingSensor)
    rec.read_watts(), rec.close()
    with pytest.raises(ValueError, match="unknown sensor spec"):
        obs.make_sensor("thermocouple")


def test_nvml_sensor_unavailable_without_the_nvml_library(monkeypatch):
    """Where `libnvidia-ml.so.1` cannot be loaded (this CPU host has no
    NVIDIA driver) the ctypes binding says so, as `make_sensor("nvml")`
    does; nothing is loaded at import.  A library name that exists
    nowhere fails the same way on any host."""
    try:
        ctypes.CDLL(sensors_mod.NVML_LIBRARY)
        present = True
    except OSError:
        present = False
    if not present:
        with pytest.raises(obs.SensorUnavailable, match="libnvidia-ml"):
            obs.NVMLSensor()
        with pytest.raises(obs.SensorUnavailable, match="libnvidia-ml"):
            obs.make_sensor("nvml")
    monkeypatch.setattr(sensors_mod, "NVML_LIBRARY", "libno-such-nvml.so.9")
    with pytest.raises(obs.SensorUnavailable, match="libno-such-nvml"):
        obs.NVMLSensor(index=3)
    with pytest.raises(obs.SensorUnavailable, match="libno-such-nvml"):
        obs.make_sensor("nvml")


class _FakeNVML:
    """The four NVML calls the sensor makes, scripted: `fail` names the
    call that returns an error code."""

    def __init__(self, fail=None, milliwatts=123456):
        self.fail = fail
        self.milliwatts = milliwatts
        self.shutdowns = 0
        for name in ("nvmlInit_v2", "nvmlDeviceGetHandleByIndex_v2",
                     "nvmlDeviceGetPowerUsage", "nvmlDeviceGetUUID"):
            setattr(self, name, self._call(name))

    def _call(self, name):
        def fn(*args):
            if name == self.fail:
                return 999
            if name == "nvmlDeviceGetPowerUsage":
                args[1]._obj.value = self.milliwatts
            if name == "nvmlDeviceGetUUID":
                args[1].value = b"GPU-0123abcd"
            return 0
        return fn

    def nvmlShutdown(self):
        self.shutdowns += 1
        return 0

    @staticmethod
    def nvmlErrorString(rc):
        return f"scripted error {rc}".encode()


@pytest.mark.parametrize("fail", ["nvmlInit_v2",
                                  "nvmlDeviceGetHandleByIndex_v2"])
def test_nvml_sensor_init_failures_raise_unavailable(monkeypatch, fail):
    lib = _FakeNVML(fail=fail)
    monkeypatch.setattr(sensors_mod, "_load_nvml", lambda: lib)
    with pytest.raises(obs.SensorUnavailable, match="scripted error 999"):
        obs.NVMLSensor()
    # A device that is missing after a good init shuts NVML down again.
    assert lib.shutdowns == (fail == "nvmlDeviceGetHandleByIndex_v2")


def test_nvml_sensor_reads_milliwatts_as_watts(monkeypatch):
    lib = _FakeNVML(milliwatts=312250)
    monkeypatch.setattr(sensors_mod, "_load_nvml", lambda: lib)
    s = obs.NVMLSensor(index=0)
    assert s.name == "nvml:0"
    assert s.read_watts() == 312.25
    assert s.uuid() == "GPU-0123abcd"
    lib.fail = "nvmlDeviceGetPowerUsage"
    with pytest.raises(obs.SensorUnavailable, match="PowerUsage"):
        s.read_watts()
    s.close()
    assert lib.shutdowns == 1


# ---------------------------------------------------------------------------
# EnergyMeter
# ---------------------------------------------------------------------------


def test_energy_meter_trapezoid_exact_on_linear_ramp():
    # w(t) = 2 + 3t over [0, 4]: integral = 32 J exactly.
    bench = _Bench(lambda t: 2.0 + 3.0 * t)
    m = obs.EnergyMeter(bench.sensor, clock=bench.clock, background=False)
    with m.measure() as meas:
        for t in (1.0, 2.0, 3.0):
            bench.t = t
            meas.sample()
        bench.t = 4.0
    assert meas.times == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert meas.joules == 32.0
    assert meas.avg_watts == pytest.approx(8.0)
    assert meas.peak_watts == 14.0
    assert meas.duration_s == 4.0


def test_energy_meter_trapezoid_second_order_on_quadratic():
    bench = _Bench(lambda t: t * t)
    m = obs.EnergyMeter(bench.sensor, clock=bench.clock, background=False)
    with m.measure() as meas:
        for i in range(1, 8):
            bench.t = i * 0.25
            meas.sample()
        bench.t = 2.0
    assert meas.joules - 8.0 / 3.0 == pytest.approx(1.0 / 48.0)


def test_energy_meter_constant_signal_is_exact():
    bench = _Bench(lambda t: 17.3)
    m = obs.EnergyMeter(bench.sensor, clock=bench.clock, background=False)
    with m.measure() as meas:
        bench.t = 0.7
    assert meas.avg_watts == 17.3            # exact, not approx
    assert meas.joules == 17.3 * meas.duration_s
    summary = meas.summary()
    assert summary["n_samples"] == 2 and summary["sensor"] == "bench"


def test_energy_meter_background_thread_samples():
    bench = _Bench(lambda t: 5.0)
    m = obs.EnergyMeter(bench.sensor, hz=200.0)
    with m.measure() as meas:
        time.sleep(0.05)
    assert meas.n_samples >= 3               # entry + exit + background
    assert meas.avg_watts == 5.0
    with pytest.raises(ValueError):
        obs.EnergyMeter(bench.sensor, hz=0.0)


def test_energy_meter_counts_errors_and_keeps_sampling():
    bench = _Bench(None)
    sensor = _FaultySensor(watts=9.0, raise_at={1}, nan_at={3})
    m = obs.EnergyMeter(sensor, clock=bench.clock, background=False)
    with m.measure() as meas:
        for t in (1.0, 2.0, 3.0):            # reads 1 (raises), 2, 3 (NaN)
            bench.t = t
            meas.sample()
        bench.t = 4.0
    assert meas.sample_errors == 2
    assert meas.n_samples == 3
    assert meas.avg_watts == 9.0
    assert meas.joules == 9.0 * 4.0
    assert meas.summary()["sample_errors"] == 2


def test_energy_meter_background_thread_survives_raising_sensor():
    sensor = _FaultySensor(watts=5.0, raise_at=set(range(1, 10_000, 2)))
    m = obs.EnergyMeter(sensor, hz=500.0)
    with m.measure() as meas:
        time.sleep(0.05)
    assert meas.sample_errors >= 2
    assert meas.n_samples >= 2
    assert meas.avg_watts == 5.0


def test_energy_meter_all_samples_failed_finalizes_to_zeros():
    bench = _Bench(None)
    sensor = _FaultySensor(raise_at=set(range(100)))
    m = obs.EnergyMeter(sensor, clock=bench.clock, background=False)
    with m.measure() as meas:
        bench.t = 1.0
        meas.sample()
    assert meas.n_samples == 0 and meas.sample_errors == 3
    s = meas.summary()
    assert s["joules"] == 0.0 and s["duration_s"] == 0.0


@pytest.mark.parametrize("loop", [True, False])
def test_meter_matches_the_reference_on_the_same_trace(loop):
    """The rails trace replayed through both packages' meters, each
    sampled at the same injected clock times, past the trace's end: the
    same joules, average and peak watts, bit for bit."""
    def run(pkg):
        t = {"now": 0.0}
        sensor = pkg.ReplaySensor(DATA_TRACE, loop=loop)
        meter = pkg.EnergyMeter(sensor, clock=lambda: t["now"],
                                background=False)
        with meter.measure() as m:
            for i in range(1, 70):
                t["now"] = 0.05 * i + 0.001 * (i % 7)
                m.sample()
            t["now"] = 4.0
        return m
    a, b = run(obs), run(ref_obs)
    assert (a.joules, a.avg_watts, a.peak_watts, a.duration_s,
            a.n_samples) == (b.joules, b.avg_watts, b.peak_watts,
                             b.duration_s, b.n_samples)
    assert a.watts == b.watts and a.times == b.times
    assert a.joules > 0 and math.isfinite(a.avg_watts)


# ---------------------------------------------------------------------------
# Degradation: replay exhaustion and fallback chains
# ---------------------------------------------------------------------------


def test_replay_sensor_exhaustion_holds_and_warns_once():
    src = io.StringIO('{"t": 0, "watts": 3.0}\n{"t": 1, "watts": 7.0}\n')
    sink = io.StringIO()
    with obs.observing(sink) as sess:
        s = obs.ReplaySensor(src, loop=False)
        assert [s.read_watts() for _ in range(6)] == [3, 7, 7, 7, 7, 7]
        assert s.exhausted
        assert sess.metrics.counter("sensor_faults_total").value == 1
    events = [r for r in _rows(sink) if r["name"] == "fault.sensor"]
    assert len(events) == 1
    assert events[0]["attrs"]["reason"] == "trace-exhausted"
    assert events[0]["attrs"]["held_watts"] == 7.0


def test_fallback_sensor_degrades_mid_run():
    first = _FaultySensor(watts=10.0, raise_at={2})
    second = _SeqSensor([20.0])
    sink = io.StringIO()
    with obs.observing(sink):
        chain = obs.FallbackSensor([first, second])
        assert chain.name == "fallback:faulty"
        assert [chain.read_watts() for _ in range(2)] == [10.0, 10.0]
        assert chain.read_watts() == 20.0
        assert chain.degradations == 1
        assert chain.name == "fallback:seq"
        assert chain.read_watts() == 20.0    # no flap-back
    events = [r for r in _rows(sink) if r["name"] == "fault.sensor"]
    assert len(events) == 1
    assert events[0]["attrs"]["degraded_to"] == "seq"
    nan_chain = obs.FallbackSensor([_FaultySensor(nan_at={0}),
                                    _SeqSensor([1.0])])
    assert math.isnan(nan_chain.read_watts())
    assert nan_chain.degradations == 0


def test_fallback_sensor_exhausted_chain_raises():
    chain = obs.FallbackSensor([_FaultySensor(raise_at={0}),
                                _FaultySensor(raise_at={0})])
    with pytest.raises(obs.SensorUnavailable, match="chain exhausted"):
        chain.read_watts()
    with pytest.raises(obs.SensorUnavailable):
        obs.FallbackSensor([])


def test_fallback_from_specs_skips_dead_constructors(monkeypatch,
                                                     tmp_path):
    """nvml (its library absent) and a missing trace are skipped with one
    construct event each; the chain serves from `simulated`."""
    monkeypatch.setattr(sensors_mod, "NVML_LIBRARY", "libno-such-nvml.so.9")
    plat = DVFSPlatform(energy.JETSON_AGX_ORIN)
    sink = io.StringIO()
    with obs.observing(sink):
        s = obs.make_sensor(
            f"fallback:nvml,replay:{tmp_path / 'missing.jsonl'},simulated",
            platform=plat)
    assert isinstance(s, obs.FallbackSensor)
    assert s.name.startswith("fallback:simulated:")
    assert s.read_watts() > 0.0
    skipped = [r for r in _rows(sink) if r["name"] == "fault.sensor"]
    assert len(skipped) == 2
    assert all(r["attrs"]["phase"] == "construct" for r in skipped)
    with pytest.raises(obs.SensorUnavailable, match="no sensor in the"):
        obs.make_sensor("fallback:nvml,sysfs")
    dead = obs.FallbackSensor([_FaultySensor(raise_at=set(range(100)))])
    bench = _Bench(None)
    m = obs.EnergyMeter(dead, clock=bench.clock, background=False)
    with m.measure() as meas:
        bench.t = 1.0
    assert meas.sample_errors == 2 and meas.n_samples == 0


# ---------------------------------------------------------------------------
# EngineEnvironment: sensor=None vs sensor="simulated"
# ---------------------------------------------------------------------------


def _stub_continuous(reqs, n_slots, **kw):
    recs = [RequestRecord(rid=r.rid, arrival_s=r.arrival_s,
                          admit_s=r.arrival_s + 0.5,
                          prompt_len=len(r.prompt), slot=r.rid % n_slots,
                          finish_s=r.arrival_s + 2.0,
                          n_tokens=r.max_new_tokens) for r in reqs]
    return {}, ContinuousStats(
        prefill_s=0.125, decode_s=0.5,
        tokens_out=sum(r.n_tokens for r in recs), sim_s=9.0,
        decode_steps=12, prefill_calls=4, n_requests=len(recs),
        mean_occupancy=1.5, mean_queue_wait_s=0.5, records=recs)


def _stub_engine(vocab=64):
    return types.SimpleNamespace(
        bundle=types.SimpleNamespace(
            cfg=types.SimpleNamespace(vocab_size=vocab)),
        max_seq_len=64, prompt_bucket=16,
        generate=lambda prompts, mnt: (
            None, EngineStats(prefill_s=0.25, decode_s=0.75,
                              tokens_out=len(prompts) * mnt)),
        generate_continuous=_stub_continuous)


@pytest.mark.parametrize("scheduler", ["static", "continuous"])
def test_engine_env_bit_identical_with_simulated_sensor(scheduler):
    board = energy.JETSON_AGX_ORIN
    work = energy.ORIN_WORKLOADS["llama3.2-1b"]

    def mk(sensor):
        return EngineEnvironment(_stub_engine(), board, work, seed=7,
                                 sensor=sensor, scheduler=scheduler,
                                 requests_per_pull=5)
    plain, metered = mk(None), mk("simulated")
    for knobs in ({"freq_mhz": board.freqs_mhz[2], "batch": 8},
                  {"freq_mhz": board.freqs_mhz[-1], "batch": 16}):
        a = plain.pull(knobs, 0)
        b = metered.pull(knobs, 0)
        assert (a.energy, a.latency, a.power) == (b.energy, b.latency,
                                                  b.power)
        assert a.batch_time == b.batch_time
        assert b.metadata["sensor"].startswith("simulated:")
        assert b.metadata["sensor_samples"] >= 2
        assert b.metadata["sensor_peak_w"] == a.power
        assert "sensor" not in a.metadata


def test_engine_env_power_is_the_meters_average():
    """With a real (here replayed) sensor the pull's power is the meter's
    average over the pull, not the board model's."""
    board = energy.JETSON_AGX_ORIN
    env = EngineEnvironment(_stub_engine(), board,
                            energy.ORIN_WORKLOADS["llama3.2-1b"], seed=7,
                            sensor=f"replay:{DATA_TRACE}")
    o = env.pull({"freq_mhz": board.freqs_mhz[-1], "batch": 4}, 0)
    assert o.metadata["sensor"] == f"replay:{DATA_TRACE}"
    samples = obs.ReplaySensor(DATA_TRACE).samples
    assert min(samples) <= o.power <= max(samples)
    assert o.power != board.power(board.n_levels - 1,
                                  env.work.utilization(4))


# ---------------------------------------------------------------------------
# serve.py --metrics-out renders with tools/trace_report.py
# ---------------------------------------------------------------------------


def test_serve_metrics_out_trace_renders(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve
    path = str(tmp_path / "serve.jsonl")
    monkeypatch.setattr(sys, "argv", [
        "serve.py", "--mode", "engine", "--rounds", "2", "--device", "cpu",
        "--scheduler", "continuous", "--metrics-out", path])
    serve.main()
    summary = json.loads(capsys.readouterr().out)
    assert summary["total_tokens"] > 0
    sys.path.insert(0, TOOLS)
    try:
        import trace_report
    finally:
        sys.path.pop(0)
    text = trace_report.report(path)
    assert "per-arm summary (2 pulls" in text
    assert "per-request summary" in text
    assert "metrics snapshot:" in text
    names = {json.loads(line)["name"] for line in open(path)}
    assert {"pull", "commit", "engine.request", "engine.decode"} <= names
    assert np.isfinite(summary["mean_power_w"])
