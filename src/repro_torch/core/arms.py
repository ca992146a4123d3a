"""Arm space: the Cartesian grid of tunable knobs.

The paper's arms are (GPU frequency x batch size): 7 x 7 = 49.  We generalize
to an ordered dict of named knobs so that beyond-paper knobs (mesh-slice
width for elastic serving, decode microbatch, ...) compose into the same
bandit without touching core/bandit.py.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

# Jetson AGX Orin GA10B GPU DVFS steps (MHz) used by the paper: 7 levels
# from 306 to 930.75.  The interior steps follow the Orin devfreq table.
JETSON_FREQS_MHZ: Tuple[float, ...] = (
    306.0, 408.0, 510.0, 612.0, 714.0, 816.0, 930.75)

# Paper batch grid: 4..28 step 4.
PAPER_BATCH_SIZES: Tuple[int, ...] = (4, 8, 12, 16, 20, 24, 28)

# TPU v5e perf states (relative clock).  Mirrors the 7-level structure; 1.0 =
# nominal 940 MHz-class clock -> 197 TFLOP/s bf16.
TPU_PERF_STATES: Tuple[float, ...] = (0.45, 0.55, 0.64, 0.73, 0.82, 0.91, 1.0)


@dataclasses.dataclass(frozen=True)
class ArmSpace:
    """Ordered knob grid.  Arm index <-> knob values bijection.

    knobs: mapping name -> tuple of values (ordered; index order is
    lexicographic with the *last* knob fastest, i.e. np.ndindex order).
    """

    knobs: Tuple[Tuple[str, Tuple, ...], ...]

    @staticmethod
    def make(knobs: Mapping[str, Sequence]) -> "ArmSpace":
        frozen = tuple((name, tuple(vals)) for name, vals in knobs.items())
        for name, vals in frozen:
            if len(vals) == 0:
                raise ValueError(f"knob {name!r} has no values")
        return ArmSpace(knobs=frozen)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(name for name, _ in self.knobs)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(len(vals) for _, vals in self.knobs)

    @property
    def n_arms(self) -> int:
        return int(np.prod(self.shape))

    def values(self, arm: int) -> Dict[str, object]:
        """Arm index -> {knob: value}."""
        idx = np.unravel_index(int(arm), self.shape)
        return {name: vals[i]
                for (name, vals), i in zip(self.knobs, idx)}

    def index(self, **kv) -> int:
        """{knob: value} -> arm index (exact match required)."""
        idx = []
        for name, vals in self.knobs:
            if name not in kv:
                raise KeyError(f"missing knob {name!r}")
            idx.append(vals.index(kv[name]))
        return int(np.ravel_multi_index(tuple(idx), self.shape))

    def enumerate(self):
        """Yield (arm_index, {knob: value}) for all arms."""
        for arm, combo in enumerate(itertools.product(
                *(vals for _, vals in self.knobs))):
            yield arm, dict(zip(self.names, combo))

    def grid(self, knob: str) -> Tuple:
        for name, vals in self.knobs:
            if name == knob:
                return vals
        raise KeyError(knob)

    def corner(self, **which) -> int:
        """Convenience for the paper's default configs, e.g.
        corner(freq='max', batch='min').  `which` values are 'min'|'max'."""
        kv = {}
        for name, vals in self.knobs:
            sel = which.get(name, "max")
            kv[name] = (min(vals) if sel == "min" else max(vals))
        return self.index(**kv)


def paper_arm_space() -> ArmSpace:
    """The paper's 49-arm Jetson grid."""
    return ArmSpace.make({"freq_mhz": JETSON_FREQS_MHZ,
                          "batch": PAPER_BATCH_SIZES})


def tpu_arm_space(batch_sizes: Sequence[int] = PAPER_BATCH_SIZES) -> ArmSpace:
    """TPU-adapted grid: perf state x batch."""
    return ArmSpace.make({"perf_state": TPU_PERF_STATES,
                          "batch": tuple(batch_sizes)})


def tpu_elastic_arm_space(
    batch_sizes: Sequence[int] = PAPER_BATCH_SIZES,
    slice_widths: Sequence[int] = (1, 2, 4),
) -> ArmSpace:
    """Beyond-paper: adds mesh-slice width (number of model-parallel replica
    groups powered on) as a third knob for elastic pod-scale serving."""
    return ArmSpace.make({"perf_state": TPU_PERF_STATES,
                          "batch": tuple(batch_sizes),
                          "slice_width": tuple(slice_widths)})
