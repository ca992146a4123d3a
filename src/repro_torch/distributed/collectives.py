"""The ring model of collective traffic, the port's copy of the
framework-free part of `repro.distributed.collectives` (`_wire`,
`summarize`): bytes on the wire per device of each collective,

    all-gather        (g-1)/g * full_bytes
    reduce-scatter    (g-1)/g * full_bytes
    all-reduce        2 (g-1)/g * full_bytes      (RS + AG)
    all-to-all        (g-1)/g * full_bytes
    collective-permute  full_bytes

where full_bytes is the op's (logical) payload size and g its group size.
The data-parallel train step (`launch/steps.py`) reports its gradient
all-reduce through it.

No counterpart: the reference's HLO parsers (`parse_collectives`, and all
of `hlo_analysis.py`) read collectives out of a compiled XLA program's
text; the port compiles no XLA program, and its collectives are the calls
it makes itself, whose payloads it knows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    dtype: str
    shape: tuple
    payload_bytes: int
    group_size: int
    wire_bytes: float     # ring-model bytes per device


def _wire(kind: str, payload: int, g: int) -> float:
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * frac * payload
    if kind == "collective-permute":
        return float(payload)
    return frac * payload


def op(kind: str, dtype: str, shape: tuple, payload_bytes: int,
       group_size: int) -> CollectiveOp:
    """One collective with its ring-model wire bytes."""
    return CollectiveOp(kind=kind, dtype=dtype, shape=tuple(shape),
                        payload_bytes=payload_bytes, group_size=group_size,
                        wire_bytes=_wire(kind, payload_bytes, group_size))


def summarize(ops: List[CollectiveOp]) -> Dict[str, float]:
    by_kind: Dict[str, float] = {}
    total_payload = 0.0
    total_wire = 0.0
    for o in ops:
        by_kind[o.kind] = by_kind.get(o.kind, 0.0) + o.wire_bytes
        total_payload += o.payload_bytes
        total_wire += o.wire_bytes
    return {
        "n_collectives": len(ops),
        "payload_bytes": total_payload,
        "wire_bytes_per_device": total_wire,
        **{f"wire_{k}": v for k, v in sorted(by_kind.items())},
    }
