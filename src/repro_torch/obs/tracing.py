"""Span/event tracing with a JSONL exporter, plus the process-wide
observation session the instrumented seams report to.

Trace schema (one JSON object per line, in emission order):

    {"kind": "event", "name": "pull", "ts": 1.234, "attrs": {...}}
    {"kind": "span",  "name": "engine.decode", "ts": ..., "dur_s": 0.08,
     "attrs": {...}}
    {"kind": "metric", "name": "pulls_total", "metric_type": "counter",
     "value": 49.0}

`ts` is seconds since the session opened (monotonic clock).  `span` rows
are events that carry a measured duration; they are emitted at the span's
END, so a trace is strictly time-ordered by emission.  `metric` rows are
the registry snapshot appended when the session closes, so a single file
holds both the timeline and the run totals (`tools/trace_report.py`
renders both).

Instrumentation contract — why this is safe on hot paths
--------------------------------------------------------
The seams (controller rounds, bandit updates, dispatcher waves, engine
prefill/decode) call the module-level `emit(...)` / `active()` helpers.
With no session open, `active()` is one global read and `emit` returns
immediately — observability is strictly additive and cannot perturb
numerics, RNG streams, or control flow, which is what keeps default runs
bit-identical to the uninstrumented code.

The well-known event names and the per-event metrics they drive live in
`_EVENT_METRICS` / `ObsSession.emit`; new seams can emit any name — every
event also bumps a generic ``events_total.<name>`` counter.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import IO, Optional, Union

from repro_torch.obs.metrics import MetricsRegistry


def _json_default(value):
    """Serialize numpy/jax scalars and other strays without importing
    either library: anything with .item() unwraps, the rest reprs."""
    item = getattr(value, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:  # noqa: BLE001 - fall through to repr
            pass
    return repr(value)


class ObsSession:
    """One observation session: a JSONL trace sink + a metrics registry
    sharing one clock.  Open via `observing(path)` (the module-level
    context manager below) so instrumented seams see it."""

    def __init__(self, sink: Union[str, IO[str], None],
                 clock=time.monotonic):
        self._own_sink = isinstance(sink, str)
        self._sink = open(sink, "w") if self._own_sink else sink
        self._clock = clock
        self.t0 = clock()
        self.metrics = MetricsRegistry()
        self.closed = False

    # -- per-event metric fan-out ------------------------------------------
    # event name -> list of (metric kind, metric name, attr key or None).
    # None attr key means "count the event"; histograms read the attr.
    _EVENT_METRICS = {
        "pull": [("counter", "pulls_total", None),
                 ("histogram", "pull_energy_j", "energy_j"),
                 ("histogram", "pull_latency_s", "latency_s"),
                 ("histogram", "pull_edp", "edp"),
                 ("histogram", "pull_cost", "cost")],
        "round.start": [("counter", "rounds_total", None)],
        "update": [("counter", "updates_total", None)],
        "update.stale": [("counter", "updates_stale_total", None),
                         ("histogram", "update_staleness", "staleness")],
        "commit": [("counter", "commits_total", None)],
        "dispatch.submit": [("counter", "dispatch_submits_total", None)],
        "dispatch.wave": [("counter", "dispatch_waves_total", None),
                          ("gauge", "dispatch_clock_s", "clock_s")],
        "engine.prefill": [("counter", "engine_prefills_total", None),
                           ("histogram", "engine_prefill_s", "dur_s")],
        "engine.decode": [("counter", "engine_decodes_total", None),
                          ("histogram", "engine_decode_s", "dur_s"),
                          ("histogram", "engine.tokens_per_s",
                           "tokens_per_s")],
        "engine.request": [("counter", "engine_requests_total", None),
                           ("histogram", "engine_request_latency_s",
                            "dur_s"),
                           ("histogram", "engine_queue_wait_s",
                            "queue_wait_s"),
                           ("histogram", "engine_request_tokens",
                            "tokens")],
        "sensor.run": [("gauge", "sensor_joules", "joules"),
                       ("gauge", "sensor_avg_w", "avg_watts"),
                       ("gauge", "sensor_peak_w", "peak_watts")],
        # Fault injection/degradation seams (repro.faults + the resilient
        # dispatcher/sensors/engine): injections vs responses count
        # separately so a chaos run's trace answers both "what was
        # injected" and "what did the stack do about it".
        "fault.inject": [("counter", "faults_injected_total", None)],
        "fault.sensor": [("counter", "sensor_faults_total", None)],
        "fault.pull": [("counter", "pull_faults_total", None)],
        "fault.retry": [("counter", "retries_total", None),
                        ("histogram", "retry_backoff_s", "backoff_s")],
        "fault.device": [("counter", "device_faults_total", None)],
        "fault.request": [("counter", "request_faults_total", None)],
    }

    def now(self) -> float:
        return self._clock() - self.t0

    def emit(self, name: str, kind: str = "event",
             dur_s: Optional[float] = None, **attrs) -> None:
        if self.closed:
            return
        row = {"kind": "span" if dur_s is not None else kind,
               "name": name, "ts": round(self.now(), 9)}
        if dur_s is not None:
            row["dur_s"] = float(dur_s)
        if attrs:
            row["attrs"] = attrs
        self._write(row)
        self.metrics.counter(f"events_total.{name}").inc()
        for mkind, mname, key in self._EVENT_METRICS.get(name, ()):
            if mkind == "counter":
                self.metrics.counter(mname).inc()
            else:
                value = dur_s if key == "dur_s" else attrs.get(key)
                if value is None:
                    continue
                if mkind == "gauge":
                    self.metrics.gauge(mname).set(float(value))
                else:
                    self.metrics.histogram(mname).observe(float(value))

    def _write(self, row: dict) -> None:
        if self._sink is not None:
            self._sink.write(json.dumps(row, default=_json_default) + "\n")

    def close(self) -> None:
        """Append the metrics snapshot and close the sink (idempotent)."""
        if self.closed:
            return
        for snap in self.metrics.snapshot():
            self._write({"kind": "metric", "ts": round(self.now(), 9),
                         **snap})
        if self._sink is not None:
            self._sink.flush()
            if self._own_sink:
                self._sink.close()
        self.closed = True


# ---------------------------------------------------------------------------
# The process-wide active session (None = observability disabled, the
# default: `active()` is a single global read on hot paths)
# ---------------------------------------------------------------------------

_SESSION: Optional[ObsSession] = None


def session() -> Optional[ObsSession]:
    """The active observation session, or None when disabled."""
    return _SESSION


def active() -> bool:
    """Cheap hot-path guard: is an observation session open?"""
    return _SESSION is not None


def set_session(sess: Optional[ObsSession]) -> Optional[ObsSession]:
    """Install `sess` as the active session; returns the previous one."""
    global _SESSION
    prev, _SESSION = _SESSION, sess
    return prev


def emit(name: str, kind: str = "event", dur_s: Optional[float] = None,
         **attrs) -> None:
    """Emit an event/span into the active session (no-op when none)."""
    if _SESSION is not None:
        _SESSION.emit(name, kind=kind, dur_s=dur_s, **attrs)


@contextlib.contextmanager
def observing(sink: Union[str, IO[str], None]):
    """Open an observation session writing JSONL to `sink` (a path or a
    file-like object), install it for the instrumented seams, and close
    it (appending the metrics snapshot) on exit.  Yields the session.

    Nesting restores the previous session on exit, so a benchmark
    harness can observe a whole sweep while an inner tool observes one
    run.
    """
    sess = ObsSession(sink)
    prev = set_session(sess)
    try:
        yield sess
    finally:
        set_session(prev)
        sess.close()
