"""FIFO request queue + fixed-size batcher (the paper's batching policy:
accumulate exactly `b` requests, then fire the batch)."""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, List, Optional

from repro_torch.serving.requests import Request


def require_positive_rate(value: float, knob: str = "arrival_rate",
                          unit: str = "requests/s") -> float:
    """Validate a rate-like knob that the queueing model divides by.

    Every serving environment ultimately computes ``wait ~ b / (2*rate)``
    and ``backlog ~ t_b - b / rate``; a zero, negative, NaN or infinite
    rate turns those into nonsense (or a ZeroDivisionError deep inside a
    jitted landscape).  Raises TypeError for non-numeric input and
    ValueError naming the offending knob otherwise; returns the value
    as a float.
    """
    try:
        v = float(value)
    except (TypeError, ValueError):
        raise TypeError(
            f"{knob} must be a positive real ({unit}), got "
            f"{value!r}") from None
    if not math.isfinite(v) or v <= 0:
        raise ValueError(
            f"{knob} must be a positive, finite {unit} value — the "
            f"queueing model divides by it — got {value!r}")
    return v


@dataclasses.dataclass
class Batch:
    bid: int
    requests: List[Request]
    ready_s: float        # when the b-th request arrived
    start_s: float = 0.0  # when the server began processing
    finish_s: float = 0.0

    @property
    def size(self) -> int:
        return len(self.requests)


class FIFOBatcher:
    """Accumulates arrivals; emits a Batch once `batch_size` requests are
    queued.  `batch_size` may change between batches (the controller's
    application-level knob)."""

    def __init__(self):
        self._queue: Deque[Request] = collections.deque()
        self._next_bid = 0

    def add(self, req: Request) -> None:
        self._queue.append(req)

    def __len__(self) -> int:
        return len(self._queue)

    def try_pop_batch(self, batch_size: int) -> Optional[Batch]:
        """Returns a Batch if at least `batch_size` requests are queued."""
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if len(self._queue) < batch_size:
            return None
        reqs = [self._queue.popleft() for _ in range(batch_size)]
        ready = max(r.arrival_s for r in reqs)
        batch = Batch(bid=self._next_bid, requests=reqs, ready_s=ready)
        self._next_bid += 1
        return batch

    def drain(self) -> List[Request]:
        out = list(self._queue)
        self._queue.clear()
        return out
