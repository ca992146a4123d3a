"""The `Platform` contract of the port: one hardware abstraction for every
backend — a copy of the parts of `repro.platform.base` that the engine
path uses (`Platform`, `DVFSPlatform`, `BaseEnvironment`, `FailedPull`).

* `levels` — the knob values the arm space enumerates (DVFS frequencies in
  MHz on a Jetson board);
* `power(level, util)` — mean watts at a level and utilization;
* `set_level(level)` — actuate the level (simulation adapters record it; a
  real deployment writes the devfreq sysfs node here).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Protocol, Sequence, Tuple, \
    runtime_checkable

from repro_torch.platform.telemetry import Observation


@runtime_checkable
class Platform(Protocol):
    """Frequency/perf-level hardware abstraction."""

    @property
    def name(self) -> str: ...

    @property
    def knob_name(self) -> str:
        """Arm-space knob this platform's levels populate
        (e.g. 'freq_mhz', 'perf_state')."""
        ...

    @property
    def levels(self) -> Tuple[float, ...]: ...

    @property
    def n_levels(self) -> int: ...

    def level_of(self, value) -> int: ...

    def power(self, level: int, util: float = 1.0) -> float: ...

    def set_level(self, level: int) -> None: ...


class _LevelMixin:
    """Shared level bookkeeping for the concrete adapters."""

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def level_of(self, value) -> int:
        for i, v in enumerate(self.levels):
            if abs(float(v) - float(value)) < 1e-6:
                return i
        raise ValueError(f"{value!r} is not a level of {self.name}; "
                         f"have {tuple(self.levels)}")

    def set_level(self, level: int) -> None:
        if not 0 <= int(level) < self.n_levels:
            raise ValueError(f"level {level} out of range "
                             f"[0, {self.n_levels}) for {self.name}")
        self.current_level = int(level)


class DVFSPlatform(_LevelMixin):
    """Adapter: a DVFS board (e.g. `serving.energy.DVFSBoard`) as a
    Platform.  Levels are the board's DVFS frequencies in MHz."""

    knob_name = "freq_mhz"

    def __init__(self, board):
        self.board = board
        self.current_level = board.n_levels - 1

    @property
    def name(self) -> str:
        return self.board.name

    @property
    def levels(self) -> Tuple[float, ...]:
        return tuple(self.board.freqs_mhz)

    def power(self, level: int, util: float = 1.0) -> float:
        return self.board.power(level, util)


class BaseEnvironment:
    """Optional base class for environments: carries the `platform` handle
    and supplies the sequential `pull_many` fallback of the batched-
    evaluation hook (async/sharded controllers and the registry's
    `pull_many` call it; vectorized backends override it).

    A backend whose observations do not depend on `round_index` (the
    closed-form landscapes) sets `round_independent = True`; composite
    dispatchers (the fleet) only hand such backends a whole slot group in
    one vectorized call, because a group's logical rounds are generally
    non-contiguous and cannot be expressed through the slot-i =
    round_index + i contract."""

    platform: Platform = None
    round_independent: bool = False

    def pull(self, knobs, round_index: int) -> Observation:
        raise NotImplementedError

    def pull_many(self, knobs_list: Sequence[dict], round_index: int = 0
                  ) -> List[Observation]:
        """Sequential fallback of the batched hook.  Contract: slot i is
        logical round ``round_index + i`` (see registry.pull_many);
        vectorized overrides must preserve that mapping wherever their
        dynamics depend on the round."""
        return [Observation.of(self.pull(k, round_index + i))
                for i, k in enumerate(knobs_list)]


@dataclasses.dataclass(frozen=True)
class FailedPull:
    """One failed pull attempt (or a fully exhausted pull): which worker
    it was tried on, why it failed, and when on the simulated timeline.
    The dispatcher records one per failed *attempt*; the controller
    records one per pull whose every attempt failed."""

    ticket: int               # the pull's ticket (shared across attempts)
    worker: int               # worker the attempt ran on (-1: none healthy)
    knobs: Dict[str, object]  # the arm's knob values
    reason: str               # "crash" | "flaky" | "timeout" | ...
    submitted_at: float       # dispatcher clock at submission
    failed_at: float          # simulated instant the failure surfaced
    attempts: int             # attempt count when this failure happened
