"""Analytical DVFS board and workload models — a copy of the parts of
`repro.serving.energy` that the engine environment uses: the Jetson AGX
Orin board (`DVFSBoard`, paper Eq. 2 power) and the per-model workload
fits (`WorkloadModel`, Eq. 3 frequency scaling and utilization).

Energy on the engine path is this *Orin analytical model* applied to
measured wall time: on an H100 it is a modelled figure, not a
measurement of the card's power.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

@dataclasses.dataclass(frozen=True)
class DVFSBoard:
    """A DVFS-capable accelerator board (paper: Jetson AGX Orin GA10B)."""

    name: str
    freqs_mhz: Tuple[float, ...]   # available clock levels, ascending
    voltages: Tuple[float, ...]    # V at each level (DVFS ladder)
    p_static: float                # W   (P0 in Eq. 2)
    c_eff: float                   # W / (V^2 * GHz)   (C in Eq. 2)

    def __post_init__(self):
        if len(self.freqs_mhz) != len(self.voltages):
            raise ValueError("freqs/voltages length mismatch")
        if list(self.freqs_mhz) != sorted(self.freqs_mhz):
            raise ValueError("freqs must be ascending")

    @property
    def n_levels(self) -> int:
        return len(self.freqs_mhz)

    @property
    def f_max(self) -> float:
        return self.freqs_mhz[-1]

    def level_of(self, freq_mhz: float) -> int:
        for i, f in enumerate(self.freqs_mhz):
            if abs(f - freq_mhz) < 1e-6:
                return i
        raise ValueError(f"{freq_mhz} MHz is not a DVFS level of {self.name}")

    def power(self, level: int, util: float = 1.0) -> float:
        """Eq. 2 with utilization: P0 + C * V^2 * f * u."""
        v = self.voltages[level]
        f_ghz = self.freqs_mhz[level] / 1000.0
        return self.p_static + self.c_eff * v * v * f_ghz * float(util)


@dataclasses.dataclass(frozen=True)
class WorkloadModel:
    """Per-(model, board) latency/utilization fit."""

    name: str
    t_unit: float      # s per work-unit at f_max
    c0_units: float    # fixed per-batch overhead (work units; C0/c_p in Eq. 3)
    kappa: float       # frequency-insensitive share of batch time at f_max
    pu: float          # utilization exponent: u(b) = (b/b_ref)^pu
    b_ref: int = 28
    tokens_out: int = 70  # paper: max generated tokens per request

    def freq_factor(self, board: DVFSBoard, level: int) -> float:
        f = board.freqs_mhz[level]
        return self.kappa + (1.0 - self.kappa) * board.f_max / f

    def batch_time(self, board: DVFSBoard, level: int, batch: int,
                   work_scale: float = 1.0) -> float:
        """Eq. 3: t_batch.  `work_scale` scales per-request work c_p (token
        length sensitivity, Fig. 8)."""
        return (self.t_unit * (self.c0_units + work_scale * batch)
                * self.freq_factor(board, level))

    def utilization(self, batch: int) -> float:
        return (batch / float(self.b_ref)) ** self.pu


# ---------------------------------------------------------------------------
# Energy / latency per (frequency level, batch) arm
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Calibrated profiles (paper hardware)
# ---------------------------------------------------------------------------

#: Jetson AGX Orin GA10B (paper board).  The 930.75 MHz step is the
#: MAXN-mode point with a disproportionate voltage bump — this is what makes
#: the top step energy-inefficient and creates the interior optimum.
JETSON_AGX_ORIN = DVFSBoard(
    name="jetson_agx_orin",
    freqs_mhz=(306.0, 408.0, 510.0, 612.0, 714.0, 816.0, 930.75),
    voltages=(0.74, 0.76, 0.78, 0.80, 0.80, 0.80, 0.93),
    p_static=14.0,
    c_eff=75.0,
)

#: Llama3.2-1B (Q5_K_M) on Orin via llama.cpp.  kappa from the paper's 56%
#: batching-time reduction (306->930.75 MHz); t_unit from t_batch(930.75, 4)
#: = 2.86 s; c0/pu calibrated to the (816 MHz, 20) optimum and the -29.9% EDP.
LLAMA32_1B_ORIN = WorkloadModel(
    name="llama3.2-1b",
    t_unit=2.86 / 52.0,
    c0_units=48.0,
    kappa=0.3766,
    pu=0.2,
)

#: Qwen2.5-3B (Q5_K_M) on Orin.  t_unit from t_batch(930.75, 4) = 5.49 s (the
#: paper's "bottleneck" batch time); small c0 / kappa: the 3B model is
#: compute-dominated and saturates the GPU at any batch size (pu = 0).  The
#: (930.75 MHz, 24) optimum is enforced by queueing: every arm below
#: (930.75, 24) except (930.75, 28) is unstable at lambda = 1 req/s.
QWEN25_3B_ORIN = WorkloadModel(
    name="qwen2.5-3b",
    t_unit=5.49 / 6.0,
    c0_units=2.0,
    kappa=0.05,
    pu=0.0,
)

ORIN_WORKLOADS = {
    "llama3.2-1b": LLAMA32_1B_ORIN,
    "qwen2.5-3b": QWEN25_3B_ORIN,
}
