"""Slot-level admission scheduling for continuous batching (a copy of
`repro.serving.scheduler`).

The fused engine decodes a fixed-width pool of `n_slots` slots that all
share one global KV clock: every live slot decodes at the same scalar
position ``pos``, and each slot's valid cache region is a contiguous
suffix ``[kv_start, pos)`` of its own cache row, expressed through the
per-row boolean validity mask the models already thread as ``attn_mask``.
That single invariant — invalid positions always form a contiguous
prefix — is what lets admission reuse the decode-attention kernel's
per-row ``[kv_start, kv_len)`` windows and the one captured decode step
of the pool's width.

This module is the pure host-side state machine behind that design: slot
occupancy, admission geometry, retire/accounting, and the per-request
records.  It touches no arrays and runs no model, so the hypothesis
property tests (tests/test_continuous.py's harness, run against this
copy by tests/test_torch_continuous.py) can drive it with scripted
token streams and check the invariants exhaustively:

* a slot is never double-occupied, a request never finishes twice;
* admission geometry: a request whose bucketed prompt length is Lb joins
  at clock C by prefilling global positions ``[C - Lb, C)`` of its freed
  cache row — legal only when ``Lb <= C`` and the output budget fits
  (``C + max_new_tokens <= max_seq_len``), so the decoded suffix never
  overruns the arena;
* when no slot is live the clock may reset to zero (a fresh seed batch),
  which also recovers from arena exhaustion near ``max_seq_len``;
* queue-wait/token/energy accounting is conservative: per-request
  records sum back to the run totals.

`InferenceEngine.generate_continuous` (serving/engine.py) owns the
arrays (in-place row admission, the replayed decode step) and consults
this scheduler for every decision, so what the property tests pin is
exactly what the engine runs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class EngineRequest:
    """One generation request for the continuous engine.

    `prompt` is the token array (np.int32); `arrival_s` is the request's
    arrival on the simulation clock (0.0 = already queued).  `deadline_s`
    is an optional absolute sim-clock deadline: a pending request past it
    is abandoned, a live one is cancelled mid-generate and its slot
    refilled (the reference's fault injection stamps these; the port's
    is not written yet)."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_s: float = 0.0
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class RequestRecord:
    """Per-request accounting, finalized at retire time."""

    rid: int
    arrival_s: float
    admit_s: float
    prompt_len: int
    slot: int
    finish_s: float = 0.0
    n_tokens: int = 0
    joules: float = 0.0
    cancelled: bool = False
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def queue_wait_s(self) -> float:
        return self.admit_s - self.arrival_s

    @property
    def latency_s(self) -> float:
        """Arrival-to-finish latency (queue wait + service)."""
        return self.finish_s - self.arrival_s


class RequestQueue:
    """Arrival-ordered FIFO of pending requests.

    Requests become visible once the simulation clock passes their
    `arrival_s`; pops preserve arrival order (ties broken by rid)."""

    def __init__(self, requests: Sequence[EngineRequest] = ()):
        self._pending: List[EngineRequest] = sorted(
            requests, key=lambda r: (r.arrival_s, r.rid))

    def push(self, req: EngineRequest) -> None:
        self._pending.append(req)
        self._pending.sort(key=lambda r: (r.arrival_s, r.rid))

    def __len__(self) -> int:
        return len(self._pending)

    def arrived(self, now: float) -> List[EngineRequest]:
        """Requests whose arrival time has passed (not yet popped)."""
        return [r for r in self._pending if r.arrival_s <= now]

    def next_arrival(self) -> Optional[float]:
        return self._pending[0].arrival_s if self._pending else None

    def pop(self, req: EngineRequest) -> None:
        self._pending.remove(req)

    def expired(self, now: float) -> List[EngineRequest]:
        """Pending requests whose deadline has passed — never admitted,
        they should be popped and abandoned (`SlotScheduler.abandon`)."""
        return [r for r in self._pending
                if r.deadline_s is not None and r.deadline_s <= now]


class SlotScheduler:
    """Bookkeeping for the engine's persistent slot pool.

    One instance per `generate_continuous` call.  All methods are pure
    host-side bookkeeping; geometry violations raise RuntimeError rather
    than silently corrupting a neighbouring tenant's cache row.
    """

    def __init__(self, n_slots: int, max_seq_len: int, prompt_bucket: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.max_seq_len = max_seq_len
        self.prompt_bucket = prompt_bucket
        self.pos = 0                       # global KV clock
        self._occupant: List[Optional[int]] = [None] * n_slots  # rid per slot
        self._deadline: List[Optional[float]] = [None] * n_slots
        self._open: Dict[int, RequestRecord] = {}    # rid -> live record
        self.records: List[RequestRecord] = []       # finalized, retire order
        self._finished_rids: set = set()
        # step-weighted occupancy accumulators (mean live slots per step)
        self._occ_steps = 0
        self._occ_live = 0

    # -- geometry ----------------------------------------------------------

    def bucket_len(self, n: int) -> int:
        bkt = self.prompt_bucket
        return ((n + bkt - 1) // bkt) * bkt

    def validate_request(self, req: EngineRequest) -> None:
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens must be "
                             f">= 1, got {req.max_new_tokens}")
        lb = self.bucket_len(len(req.prompt))
        if lb + req.max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"request {req.rid}: bucketed prompt length {lb} + "
                f"max_new_tokens {req.max_new_tokens} exceeds "
                f"max_seq_len={self.max_seq_len}")

    def can_admit(self, req: EngineRequest) -> bool:
        """Admission geometry at the current clock: the prompt must fit
        behind the clock (``Lb <= pos`` — it overwrites the retired
        tenant's positions ``[pos - Lb, pos)``) and the output budget
        ahead of it (a live slot emits one token per step, so it finishes
        by ``pos + max_new_tokens``)."""
        lb = self.bucket_len(len(req.prompt))
        return (lb <= self.pos
                and self.pos + req.max_new_tokens <= self.max_seq_len)

    # -- occupancy ---------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._occupant) if r is None]

    def live_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._occupant) if r is not None]

    def any_live(self) -> bool:
        return any(r is not None for r in self._occupant)

    def rid_at(self, slot: int) -> Optional[int]:
        return self._occupant[slot]

    # -- seed / admit / retire --------------------------------------------

    def seed_group(self, arrived: Sequence[EngineRequest],
                   ) -> List[EngineRequest]:
        """Greedy seed-batch selection (clock at zero, all slots free).

        Walk `arrived` in order, growing the group while every member
        still fits under the group's common bucketed prompt length
        (``plen + member.max_new_tokens <= max_seq_len``).  The first
        request always fits alone (per-request validation), so reseeding
        never starves the queue head; skipped requests stay queued."""
        group: List[EngineRequest] = []
        plen = 0
        for req in arrived:
            if len(group) >= self.n_slots:
                break
            new_plen = max(plen, self.bucket_len(len(req.prompt)))
            members = group + [req]
            if all(new_plen + m.max_new_tokens <= self.max_seq_len
                   for m in members):
                group = members
                plen = new_plen
        return group

    def seed(self, reqs: Sequence[EngineRequest], plen: int,
             now: float) -> None:
        """(Re)start the clock at `plen` with `reqs` in slots 0..k-1.

        Legal only when no slot is live: resetting the clock while a
        tenant's window straddles it would leave garbage inside a valid
        region."""
        if self.any_live():
            raise RuntimeError("seed() with live slots would reset the "
                               "global clock under a tenant")
        if len(reqs) > self.n_slots:
            raise RuntimeError(f"seed group of {len(reqs)} exceeds "
                               f"{self.n_slots} slots")
        self.pos = plen
        self._occupant = [None] * self.n_slots
        for slot, req in enumerate(reqs):
            self._place(req, slot, now)

    def admit(self, req: EngineRequest, now: float) -> int:
        """Admit into the lowest free slot at the current clock.
        Returns the slot index; the caller prefills the cache row at
        ``pos_offset = pos - bucket_len(len(prompt))``."""
        if not self.can_admit(req):
            raise RuntimeError(
                f"request {req.rid} is not admissible at clock {self.pos} "
                f"(bucketed prompt {self.bucket_len(len(req.prompt))}, "
                f"budget {req.max_new_tokens}, max_seq {self.max_seq_len})")
        free = self.free_slots()
        if not free:
            raise RuntimeError(f"request {req.rid}: no free slot")
        slot = free[0]
        self._place(req, slot, now)
        return slot

    def _place(self, req: EngineRequest, slot: int, now: float) -> None:
        if self._occupant[slot] is not None:
            raise RuntimeError(
                f"slot {slot} is already occupied by request "
                f"{self._occupant[slot]} (attempted {req.rid})")
        if req.rid in self._open or req.rid in self._finished_rids:
            raise RuntimeError(f"request {req.rid} admitted twice")
        self._occupant[slot] = req.rid
        self._deadline[slot] = req.deadline_s
        self._open[req.rid] = RequestRecord(
            rid=req.rid, arrival_s=req.arrival_s, admit_s=now,
            prompt_len=len(req.prompt), slot=slot)

    def note_emitted(self, slot: int, tokens: Sequence[int]) -> None:
        rid = self._occupant[slot]
        if rid is None:
            raise RuntimeError(f"note_emitted on vacant slot {slot}")
        rec = self._open[rid]
        rec.tokens.extend(int(t) for t in tokens)
        rec.n_tokens += len(tokens)

    def retire(self, slot: int, now: float,
               cancelled: bool = False) -> RequestRecord:
        """Finalize the request in `slot` (exactly once) and free it."""
        rid = self._occupant[slot]
        if rid is None:
            raise RuntimeError(f"retire on vacant slot {slot}")
        rec = self._open.pop(rid)
        rec.finish_s = now
        rec.cancelled = cancelled
        self._occupant[slot] = None
        self._deadline[slot] = None
        self._finished_rids.add(rid)
        self.records.append(rec)
        return rec

    # -- deadlines / cancellation -----------------------------------------

    def due_cancellations(self, now: float) -> List[int]:
        """Live slots whose request's deadline has passed."""
        return [i for i, d in enumerate(self._deadline)
                if self._occupant[i] is not None
                and d is not None and d <= now]

    def cancel(self, slot: int, now: float) -> RequestRecord:
        """Cancel the live request in `slot`: same exactly-once retire
        machinery, but the record is flagged `cancelled` (tokens emitted
        so far stay attributed to it).  The slot frees for refill."""
        return self.retire(slot, now, cancelled=True)

    def abandon(self, req: EngineRequest, now: float) -> RequestRecord:
        """Finalize a never-admitted request whose deadline expired while
        it was still queued: a zero-token cancelled record (slot = -1)
        so conservation over records still covers every request."""
        if req.rid in self._open or req.rid in self._finished_rids:
            raise RuntimeError(f"abandon on known request {req.rid}")
        rec = RequestRecord(rid=req.rid, arrival_s=req.arrival_s,
                            admit_s=now, prompt_len=len(req.prompt),
                            slot=-1, finish_s=now, cancelled=True)
        self._finished_rids.add(req.rid)
        self.records.append(rec)
        return rec

    def advance(self, steps: int, live_at_entry: int) -> None:
        """Move the global clock by `steps` decode steps and accumulate
        the step-weighted occupancy (live slots during those steps)."""
        self.pos += steps
        self._occ_steps += steps
        self._occ_live += steps * live_at_entry

    @property
    def mean_occupancy(self) -> float:
        return self._occ_live / self._occ_steps if self._occ_steps else 0.0


def attribute_energy(records: Sequence[RequestRecord], total_joules: float,
                     ) -> None:
    """Split a run-level energy measurement across requests in proportion
    to their emitted tokens; the last request absorbs the rounding
    residue, so the parts sum back to the total to float round-off."""
    total_tokens = sum(r.n_tokens for r in records)
    if not records or total_tokens == 0 or total_joules <= 0.0:
        return
    assigned = 0.0
    for rec in records[:-1]:
        rec.joules = total_joules * (rec.n_tokens / total_tokens)
        assigned += rec.joules
    records[-1].joules = total_joules - assigned
