"""Lightweight process-local metrics: counters, gauges, histograms.

The observability layer's aggregate side (the tracer in `tracing.py` is
the per-event side): instrumented seams bump named instruments through a
`MetricsRegistry`, and a snapshot of every instrument is appended to the
trace file when an observation session closes — so one JSONL artifact
carries both the event timeline and the run totals.

Deliberately tiny and dependency-free (stdlib only): no labels, no
exemplars, no background export.  A histogram keeps streaming moments
(count / sum / min / max) plus fixed log-spaced bucket counts, which is
enough for the per-arm energy/latency/EDP summaries `tools/trace_report.py`
renders and cheap enough to leave enabled on the controller hot path.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional


class Counter:
    """Monotonically increasing count of events."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc by {amount})")
        self.value += amount

    def snapshot(self) -> dict:
        return {"name": self.name, "metric_type": "counter",
                "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[float] = None

    def set(self, value: float) -> None:
        self.value = float(value)

    def snapshot(self) -> dict:
        return {"name": self.name, "metric_type": "gauge",
                "value": self.value}


#: Default histogram buckets: log-spaced upper bounds covering the ranges
#: this repo actually observes (joules/request, seconds, EDP, watts) —
#: 1e-6 .. 1e6 in decade steps, plus +inf.
DEFAULT_BUCKETS = tuple(10.0 ** e for e in range(-6, 7)) + (math.inf,)


class Histogram:
    """Streaming distribution summary: moments + log-spaced buckets."""

    def __init__(self, name: str, buckets=DEFAULT_BUCKETS):
        self.name = name
        self.buckets = tuple(sorted(buckets))
        if not self.buckets or self.buckets[-1] != math.inf:
            self.buckets = self.buckets + (math.inf,)
        self.counts = [0] * len(self.buckets)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.counts[i] += 1
                break

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def snapshot(self) -> dict:
        return {"name": self.name, "metric_type": "histogram",
                "count": self.count, "sum": self.sum, "min": self.min,
                "max": self.max, "mean": self.mean,
                "buckets": {("+inf" if ub == math.inf else repr(ub)): c
                            for ub, c in zip(self.buckets, self.counts)
                            if c}}


class MetricsRegistry:
    """Named instruments, created on first use (`counter("pulls_total")`).

    Thread-safe creation (the EnergyMeter's background sampler may race
    the controller thread); instrument updates are plain float ops, whose
    worst race is a lost increment — acceptable for diagnostics and far
    cheaper than locking the hot path.
    """

    def __init__(self):
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        inst = self._instruments.get(name)
        if inst is None:
            with self._lock:
                inst = self._instruments.setdefault(name, cls(name, **kw))
        if not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def snapshot(self) -> List[dict]:
        """Every instrument's snapshot row, sorted by name (stable
        artifacts diff cleanly)."""
        return [self._instruments[k].snapshot()
                for k in sorted(self._instruments)]
