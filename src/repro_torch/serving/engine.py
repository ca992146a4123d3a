"""Batched PyTorch inference engine: prefill + greedy decode with a KV
cache — the static path of `repro.serving.engine`.

This is the real-model backend behind the Camel controller: pulling an arm
runs one batch through a model and turns the measured wall time into an
`Observation`.

* **Fused decode** (`decode_impl="fused"`, the default) keeps the whole
  decode loop on the device, the counterpart of the reference's jitted
  `lax.fori_loop`: the greedy argmax runs on the device, tokens go into a
  device `[B, steps]` buffer, and `generate` makes exactly one
  device->host copy.  On CUDA one decode step is captured as a CUDA graph
  per batch size (`DecodeGraph`) and each step is one replay plus the
  token write: the step reads the token, the position and the pad mask
  from static device buffers, so, as the reference's traced `start_pos`,
  a new prompt length replays the same graph.  `decode_impl="loop"`
  copies each token to the host as it is made and runs the step eagerly
  with a Python position — the reference the fused path is held
  bit-identical to.
* **Prompt bucketing** — padded prompt lengths are rounded up to
  `prompt_bucket` multiples, so a sweep over ragged prompts sees one
  prefill shape per (batch, bucket).
* **Cache pool** — one cache per batch size, reused across `generate`
  calls.  The model writes K/V in place, so a pooled cache carries the
  previous call's entries: every position a call reads was written by the
  same call (prefill writes all of [0, L), decode writes `pos` before
  attending to it) or is masked out (positions past `pos`; left-pad
  slots before `kv_start`, ring slots of negative position), so stale
  entries never reach an output.  A recurrent state (rwkv6's, and
  recurrentgemma's `lru_h` and `conv_tail`) is read whole by prefill, so
  a pooled one is zeroed before each prompt: every prefill starts from a
  zero state, as in the reference, whose functional pool is never
  written.

Left-padding batches ragged prompts: all sequences share position indices
and a boolean pad mask (`attn_mask`) keeps pad slots out of attention, so
ragged and unpadded prompts give the same per-sequence logits.

Timing mirrors the reference's `block_until_ready`: on CUDA each clock
read in `generate` follows a `torch.cuda.synchronize()`, so `EngineStats`
holds device time, not launch time.

Continuous batching (`generate_continuous`) serves a request queue on a
persistent pool of slots sharing one global KV clock, as the reference's
does, with `serving.scheduler.SlotScheduler` making every host-side
decision:

* **decode** replays the static path's captured step at the pool's width
  (one `DecodeGraph` a batch size serves both paths).  Around each replay
  the reference's while_loop body runs on the device as a few eager
  kernels: the pre-step token is written to the chunk's buffer (-1 for a
  finished or vacant slot), `emitted` counts it, and a slot finishes on
  EOS or on its budget.  The reference's loop condition (leave when every
  slot is finished, or when one is while admissible requests wait) is
  computed on the device from that step's `finished` and copied into
  pinned host memory before the replay is launched; the host waits for
  that copy only, so it decides on the next step while the device runs
  this one, and no step runs past the exit.  A chunk ends in copying its
  tokens, `finished` and `emitted` to the host.
* **admission** prefills one left-padded row at ``pos_offset = pos - Lb``
  into a zeroed one-row cache (zeroed whole, K/V included: a ring row is
  rolled into place and must hold nothing stale) and copies it into the
  freed slot of the pooled cache in place, with the slot's token and
  mask row, so the captured step sees it.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.faults import apply_request_faults, wrap_sensor
from repro_torch.kernels import launch_counts
from repro_torch.models.registry import ModelBundle
from repro_torch.obs import EnergyMeter, make_sensor
from repro_torch.obs import tracing as obslog
from repro_torch.platform.base import BaseEnvironment, DVFSPlatform
from repro_torch.platform.telemetry import Observation, observe
from repro_torch.serving.queueing import require_positive_rate
from repro_torch.serving.requests import ArrivalProcess
from repro_torch.serving.scheduler import (EngineRequest, RequestQueue,
                                           RequestRecord, SlotScheduler,
                                           attribute_energy)


@dataclasses.dataclass
class EngineStats:
    prefill_s: float
    decode_s: float
    tokens_out: int
    decode_impl: str = "fused"

    @property
    def total_s(self) -> float:
        return self.prefill_s + self.decode_s

    @property
    def tokens_per_s(self) -> float:
        """Decode throughput (generated tokens / decode wall-clock)."""
        return self.tokens_out / self.decode_s if self.decode_s > 0 else 0.0


@dataclasses.dataclass
class ContinuousStats(EngineStats):
    """Run-level stats for `generate_continuous`.

    `sim_s` is the simulation-clock duration of the run (wall time scaled
    by `time_scale`, or `step_time_s` units in deterministic mode) —
    goodput is `n_requests / sim_s`.  `records` carries the per-request
    accounting (admit/finish times, queue wait, tokens, joules)."""

    sim_s: float = 0.0
    decode_steps: int = 0
    prefill_calls: int = 0
    n_requests: int = 0
    n_cancelled: int = 0
    mean_occupancy: float = 0.0
    mean_queue_wait_s: float = 0.0
    records: List[RequestRecord] = dataclasses.field(default_factory=list)

    @property
    def goodput_rps(self) -> float:
        """Completed requests per simulated second."""
        return self.n_requests / self.sim_s if self.sim_s > 0 else 0.0


@contextlib.contextmanager
def _no_host_sync(device: torch.device):
    """On CUDA, make any host sync inside raise
    (`torch.cuda.set_sync_debug_mode("error")`); the previous mode is
    restored on the way out.  Nothing on the CPU."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


class DecodeGraph:
    """The fused path's decode step at one batch size, over that batch's
    pooled cache.  The step reads static device buffers and writes them in
    place: `tok` [B] (the input token, then the greedy argmax), `pos` (a
    0-d int64, advanced by one inside the step) and `mask` [B,
    max_seq_len] (the decode-time pad mask).  On CUDA it is captured once
    as a `torch.cuda.CUDAGraph` and `run` replays it; on the CPU `run`
    calls the same step eagerly.

    `tally` is the kernel launches one replay makes, by counter name
    (`kernels.launch_counts` over the capture, which records each launch
    once); `replays` counts replays, so a replayed run's kernel executions
    are the counters' change plus replays x tally.  `capture_s` is the
    host time of the warm-up and the capture."""

    #: Eager steps on the capture stream before the capture: they load the
    #: kernel libraries and create the stream's cuBLAS handle and
    #: workspace, which a capture must not allocate.
    WARMUP_STEPS = 2

    def __init__(self, engine: "InferenceEngine", batch: int, cache):
        dev = engine.device
        self.bundle, self.params, self.cache = \
            engine.bundle, engine.params, cache
        self.tok = torch.zeros((batch,), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.mask = torch.ones((batch, engine.max_seq_len), dtype=torch.bool,
                               device=dev)
        self.graph = None
        self.tally: Dict[str, int] = {}
        self.replays = 0
        self.capture_s = 0.0
        if dev.type == "cuda":
            self._capture()

    def _step(self) -> None:
        logits, _ = self.bundle.decode_step(self.params, self.tok, self.cache,
                                            self.pos, attn_mask=self.mask)
        self.tok.copy_(torch.argmax(logits, dim=-1))
        self.pos.add_(1)

    def _capture(self) -> None:
        """Warm up on a side stream, then capture one step on it, each
        under `_no_host_sync`: a step that syncs raises here.  The warm-up
        writes the cache (K/V at slots 0 and 1, the recurrent state); the
        caller zeroes the state before the next prefill, and K/V slots are
        rewritten or masked as for any pooled cache."""
        dev = self.tok.device
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream), _no_host_sync(dev):
            for _ in range(self.WARMUP_STEPS):
                self._step()
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            with _no_host_sync(dev):
                self._step()
        after = launch_counts()
        torch.cuda.current_stream(dev).wait_stream(stream)
        torch.cuda.synchronize(dev)
        self.tally = {k: after[k] - before[k] for k in after}
        self.graph = graph
        self.capture_s = time.monotonic() - t0

    def run(self) -> None:
        """One decode step: a replay on CUDA, the eager step on the CPU."""
        if self.graph is None:
            self._step()
        else:
            self.graph.replay()
            self.replays += 1


class InferenceEngine:
    """Greedy batched generation: one prefill, then `max_new_tokens`
    decode steps.

    decode_impl: "fused" (device-side token buffer, one host copy per
    generate; on CUDA a graph replay a step) or "loop" (a host copy per
    token, eager steps).  A fused step that cannot be captured raises:
    nothing falls back to eager decode.  prompt_bucket: padded
    prompt lengths are rounded up to this multiple.  device: where the
    engine's inputs and caches live (CUDA unless told otherwise); `params`
    must already be there.
    """

    def __init__(self, bundle: ModelBundle, params, max_batch: int,
                 max_seq_len: int, pad_id: int = 0,
                 decode_impl: str = "fused", prompt_bucket: int = 16,
                 device=None):
        if decode_impl not in ("fused", "loop"):
            raise ValueError(f"decode_impl must be 'fused' or 'loop', "
                             f"got {decode_impl!r}")
        if prompt_bucket < 1:
            raise ValueError(f"prompt_bucket must be >= 1, "
                             f"got {prompt_bucket}")
        self.device = resolve_device(device)
        self.bundle = bundle
        self.params = params
        self.max_batch = max_batch
        self.max_seq_len = max_seq_len
        self.pad_id = pad_id
        self.decode_impl = decode_impl
        self.prompt_bucket = prompt_bucket
        self._cache_pool: Dict[int, object] = {}
        # batch -> the fused path's decode step over that batch's cache
        self.decode_graphs: Dict[int, DecodeGraph] = {}
        # the one-row cache continuous admission prefills into
        self._admit_row = None
        # (entry point, batch, bucketed prompt length) -> calls
        self.calls: collections.Counter = collections.Counter()

    # -- shape management --------------------------------------------------

    def _bucket_len(self, n: int) -> int:
        bkt = self.prompt_bucket
        return ((n + bkt - 1) // bkt) * bkt

    def _pad_batch(self, prompts: List[np.ndarray],
                   ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Left-pad to the bucketed max length.
        Returns (tokens [B, L], pad mask [B, L] (True = real), L)."""
        b = len(prompts)
        plen = self._bucket_len(max(len(p) for p in prompts))
        out = np.full((b, plen), self.pad_id, np.int64)
        mask = np.zeros((b, plen), bool)
        for i, p in enumerate(prompts):
            out[i, plen - len(p):] = p       # left padding
            mask[i, plen - len(p):] = True
        return out, mask, plen

    def _cache_for(self, batch: int):
        cache = self._cache_pool.get(batch)
        if cache is None:
            cache = self.bundle.init_cache(batch, self.max_seq_len,
                                           self.device)
            self._cache_pool[batch] = cache
        else:
            self.bundle.zero_state(cache)
        return cache

    def _graph_for(self, batch: int, cache) -> DecodeGraph:
        """The fused decode step at `batch`, captured on first use (before
        the prefill: the capture's warm-up writes the state, which is
        zeroed again here).  A failed capture raises and stores nothing."""
        graph = self.decode_graphs.get(batch)
        if graph is None:
            graph = DecodeGraph(self, batch, cache)
            self.bundle.zero_state(cache)
            self.decode_graphs[batch] = graph
        return graph

    @property
    def compile_counts(self) -> Dict[str, int]:
        """The torch meaning of the reference's jit-cache sizes, plus the
        cache pool size.  "decode_fused": the decode steps the fused path
        holds, one a batch size — CUDA graphs captured on CUDA, batch
        sizes run on the CPU — which, for a fixed `max_new_tokens`,
        equals the reference's count (its `start_pos` is traced).
        "prefill" and "decode_loop": the distinct (batch, bucketed prompt
        length) shapes each has run; "admit": the distinct bucketed prompt
        lengths of continuous admission's one-row prefill (the reference's
        one trace per bucket).  A sweep that repeats shapes keeps these
        flat; `calls` has the call count per shape."""
        counts = {"prefill": 0, "decode_loop": 0, "admit": 0}
        for (entry, _, _) in self.calls:
            if entry in counts:
                counts[entry] += 1
        counts["decode_fused"] = len(self.decode_graphs)
        counts["cache_pool"] = len(self._cache_pool)
        return counts

    # -- generation --------------------------------------------------------

    def _validate(self, prompts: List[np.ndarray], max_new_tokens: int,
                  ) -> None:
        if not prompts:
            raise ValueError("generate() needs at least one prompt")
        if any(len(p) == 0 for p in prompts):
            raise ValueError("generate() got an empty prompt")
        if len(prompts) > self.max_batch:
            raise ValueError(
                f"batch of {len(prompts)} prompts exceeds max_batch="
                f"{self.max_batch}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        plen = self._bucket_len(max(len(p) for p in prompts))
        if plen + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"bucketed prompt length {plen} + max_new_tokens "
                f"{max_new_tokens} exceeds max_seq_len={self.max_seq_len} "
                f"(the KV cache would overrun)")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, prompts: List[np.ndarray], max_new_tokens: int,
                 ) -> Tuple[np.ndarray, EngineStats]:
        """Greedy-decode `max_new_tokens` for each prompt.
        Returns (tokens [B, max_new_tokens] int32, stats)."""
        self._validate(prompts, max_new_tokens)
        toks, mask, prompt_len = self._pad_batch(prompts)
        b = toks.shape[0]
        cache = self._cache_for(b)
        graph = self._graph_for(b, cache) \
            if self.decode_impl == "fused" else None
        dev = self.device

        self._sync()
        t0 = time.monotonic()
        mask_d = torch.from_numpy(mask).to(dev)
        logits, cache = self.bundle.prefill(
            self.params, torch.from_numpy(toks).to(dev), cache,
            attn_mask=mask_d)
        self.calls["prefill", b, prompt_len] += 1
        tok = torch.argmax(logits, dim=-1)
        self._sync()
        t_prefill = time.monotonic() - t0

        # Decode-time pad mask over global positions: prompt pads stay
        # invalid, every decode-written slot (>= prompt_len) is valid.
        dec_mask = torch.ones((b, self.max_seq_len), dtype=torch.bool,
                              device=dev)
        dec_mask[:, :prompt_len] = mask_d
        key = ("decode_fused" if self.decode_impl == "fused"
               else "decode_loop", b, prompt_len)
        t0 = time.monotonic()
        if graph is not None:
            graph.mask.copy_(dec_mask)
            graph.tok.copy_(tok)
            graph.pos.fill_(prompt_len)      # the step advances it
            out_d = torch.empty((b, max_new_tokens), dtype=torch.int32,
                                device=dev)
            with _no_host_sync(dev):
                for i in range(max_new_tokens):
                    out_d[:, i] = graph.tok
                    graph.run()
            out = out_d.cpu().numpy()        # the one device->host copy
        else:
            out = np.zeros((b, max_new_tokens), np.int32)
            for i in range(max_new_tokens):
                out[:, i] = tok.cpu().numpy()
                logits, cache = self.bundle.decode_step(
                    self.params, tok, cache, prompt_len + i,
                    attn_mask=dec_mask)
                tok = torch.argmax(logits, dim=-1)
        self._sync()
        t_decode = time.monotonic() - t0
        self.calls[key] += 1

        st = EngineStats(prefill_s=t_prefill, decode_s=t_decode,
                         tokens_out=b * max_new_tokens,
                         decode_impl=self.decode_impl)
        if obslog.active():
            obslog.emit("engine.prefill", dur_s=t_prefill, batch=b,
                        prompt_len=prompt_len)
            obslog.emit("engine.decode", dur_s=t_decode, batch=b,
                        tokens=st.tokens_out,
                        decode_impl=self.decode_impl,
                        tokens_per_s=st.tokens_per_s or None)
        return out, st


    # -- continuous generation ---------------------------------------------

    def _admit(self, prompt: np.ndarray, graph: DecodeGraph, slot: int,
               offset: int) -> None:
        """Prefill one request at global positions [offset, offset + Lb)
        into the zeroed one-row cache and copy that row into `slot` of the
        pooled cache, in place (batched leaves carry batch at axis 1), with
        its greedy token into the graph's token buffer."""
        lb = self._bucket_len(len(prompt))
        toks, mask, _ = self._pad_batch([prompt])
        row = self._admit_row
        if row is None:
            row = self._admit_row = self.bundle.init_cache(
                1, self.max_seq_len, self.device)
        else:
            _zero_tree(row)
        dev = self.device
        logits, row = self.bundle.prefill(
            self.params, torch.from_numpy(toks).to(dev), row,
            attn_mask=torch.from_numpy(mask).to(dev), pos_offset=offset)
        self.calls["admit", 1, lb] += 1
        _copy_row(graph.cache, row, slot)
        graph.tok[slot] = torch.argmax(logits[0], dim=-1)

    def _decode_chunk(self, graph: DecodeGraph, finished: np.ndarray,
                      remaining: np.ndarray, eos_id: Optional[int],
                      steps_cap: int, pending: int, chunk: int,
                      ) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
        """Up to `steps_cap` decode steps over the slot pool: the
        reference's while_loop (`finished` [B] and `remaining` [B] per
        slot; leave when every slot is finished, or when one is while
        `pending` admissible requests wait).  Each step's bookkeeping runs
        on the device before its replay; the exit flag it yields reaches
        the host through pinned memory while the replay runs.  Returns
        (steps, tokens [B, chunk] (-1 where none was emitted), finished,
        emitted) on the host."""
        dev = self.device
        b = finished.shape[0]
        fin = torch.from_numpy(finished).to(dev)
        rem = torch.from_numpy(remaining).to(dev)
        em = torch.zeros((b,), dtype=torch.int32, device=dev)
        out = torch.full((b, chunk), -1, dtype=torch.int32, device=dev)
        on_cuda = dev.type == "cuda"
        if on_cuda:
            flag = torch.empty((), dtype=torch.bool, pin_memory=True)
            flag_ready = torch.cuda.Event()
        # The condition before the first step, on the host's `finished`.
        if finished.all() or (finished.any() and pending > 0):
            steps_cap = 0
        steps = 0
        while steps < steps_cap:
            with _no_host_sync(dev):
                out[:, steps] = torch.where(fin, -1, graph.tok)
                em.add_(~fin)
                if eos_id is not None:
                    fin.logical_or_(graph.tok == eos_id)
                fin.logical_or_(em >= rem)
                stop = fin.all() if pending == 0 else fin.any()
                if on_cuda:
                    flag.copy_(stop, non_blocking=True)
                    flag_ready.record()
                graph.run()
            steps += 1
            if on_cuda:
                flag_ready.synchronize()
                stop = flag
            if bool(stop):
                break
        return (steps, out.cpu().numpy(), fin.cpu().numpy(),
                em.cpu().numpy())

    @torch.inference_mode()
    def generate_continuous(self, requests: Iterable[EngineRequest], *,
                            n_slots: Optional[int] = None,
                            eos_id: Optional[int] = None,
                            chunk: int = 16,
                            step_time_s: Optional[float] = None,
                            time_scale: float = 1.0,
                            ) -> Tuple[Dict[int, np.ndarray], ContinuousStats]:
        """Serve `requests` with continuous (slot-level) batching.

        Decoding runs on a persistent pool of `n_slots` slots sharing one
        global KV clock; a request that hits `eos_id` or its own
        `max_new_tokens` retires mid-run and its slot is refilled from
        the queue (admission = single-row prefill at the clock offset —
        see `_admit`).  When every slot drains the clock reseeds at zero
        with a fresh left-padded batch, which also recovers the arena near
        `max_seq_len`.  Decode runs in chunks of at most `chunk` steps, one
        host copy of tokens a chunk (see the module docstring); it replays
        the fused path's graph at `n_slots` whatever `decode_impl` is, as
        the reference runs its fused loop.

        The simulation clock orders arrivals (`EngineRequest.arrival_s`)
        against service: it advances by measured wall time × `time_scale`
        (DVFS factor), or deterministically by `step_time_s` per decode
        step / per prefill call when given.

        Returns ``({rid: tokens [n_i]}, ContinuousStats)`` — per-request
        streams are ragged (EOS-terminated streams include the EOS
        token).
        """
        reqs = list(requests)
        if not reqs:
            raise ValueError("generate_continuous() needs at least one "
                             "request")
        if len({r.rid for r in reqs}) != len(reqs):
            raise ValueError("generate_continuous() got duplicate request "
                             "ids")
        if eos_id is not None and eos_id < 0:
            raise ValueError(f"eos_id must be None or >= 0, got {eos_id}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if self.bundle.family == "encdec":
            raise ValueError(
                "continuous batching is unsupported for the encdec family "
                "(absolute sinusoidal positions forbid offset admission; "
                "see models/encdec.py)")
        b = n_slots if n_slots is not None else min(self.max_batch,
                                                    len(reqs))
        if not 1 <= b <= self.max_batch:
            raise ValueError(f"n_slots={b} outside [1, max_batch="
                             f"{self.max_batch}]")
        sched = SlotScheduler(b, self.max_seq_len, self.prompt_bucket)
        for r in reqs:
            sched.validate_request(r)
        queue = RequestQueue(reqs)
        dev = self.device

        sim = 0.0
        prefill_s = decode_s = 0.0
        decode_steps = 0
        prefill_calls = 0
        outputs: Dict[int, np.ndarray] = {}

        def tick(wall_dt: float, units: int) -> None:
            nonlocal sim
            sim += (step_time_s * units if step_time_s is not None
                    else wall_dt * time_scale)

        # The pool's decode step, captured (on CUDA) before the first
        # prefill, over the pooled cache every seed prefill fills.
        graph = self._graph_for(b, self._cache_for(b))
        # Per-slot host state between chunks.  Vacant slots carry
        # finished=True, remaining=0 and an all-True mask row.
        valid = np.ones((b, self.max_seq_len), bool)
        finished = np.ones((b,), bool)
        remaining = np.zeros((b,), np.int32)

        while len(queue) or sched.any_live():
            # Deadlines: expired pending requests are abandoned before
            # admission; live slots past their deadline retire with the
            # tokens emitted so far and free for refill.
            for req in queue.expired(sim):
                queue.pop(req)
                rec = sched.abandon(req, sim)
                outputs[req.rid] = np.zeros((0,), np.int32)
                if obslog.active():
                    obslog.emit("fault.request", rid=req.rid,
                                action="abandon",
                                deadline_s=req.deadline_s,
                                queue_wait_s=rec.queue_wait_s)
            for slot in sched.due_cancellations(sim):
                rec = sched.cancel(slot, sim)
                outputs[rec.rid] = np.asarray(rec.tokens, np.int32)
                finished[slot] = True
                remaining[slot] = 0
                if obslog.active():
                    obslog.emit("fault.request", rid=rec.rid,
                                action="cancel", slot=slot,
                                tokens=rec.n_tokens)
                    obslog.emit("engine.request", dur_s=rec.latency_s,
                                rid=rec.rid, slot=rec.slot,
                                tokens=rec.n_tokens,
                                prompt_len=rec.prompt_len,
                                queue_wait_s=rec.queue_wait_s,
                                admit_s=rec.admit_s,
                                finish_s=rec.finish_s, cancelled=True)
            if not sched.any_live():
                arrived = queue.arrived(sim)
                if not arrived:
                    sim = queue.next_arrival()   # idle: jump to next arrival
                    continue
                # Reseed: a fresh left-padded batch at clock zero, the
                # static path's prefill at batch b.
                group = sched.seed_group(arrived)
                plen = max(self._bucket_len(len(r.prompt)) for r in group)
                toks = np.full((b, plen), self.pad_id, np.int64)
                mask = np.zeros((b, plen), bool)
                mask[len(group):, :] = True      # dummy rows: defined attn
                for i, r in enumerate(group):
                    toks[i, plen - len(r.prompt):] = r.prompt
                    mask[i, plen - len(r.prompt):] = True
                cache = self._cache_for(b)
                self._sync()
                t0 = time.monotonic()
                logits, _ = self.bundle.prefill(
                    self.params, torch.from_numpy(toks).to(dev), cache,
                    attn_mask=torch.from_numpy(mask).to(dev))
                graph.tok.copy_(torch.argmax(logits, dim=-1))
                self._sync()
                dt = time.monotonic() - t0
                self.calls["prefill", b, plen] += 1
                prefill_s += dt
                prefill_calls += 1
                tick(dt, 1)
                for r in group:
                    queue.pop(r)
                sched.seed(group, plen, sim)
                valid = np.ones((b, self.max_seq_len), bool)
                valid[:, :plen] = mask
                graph.mask.copy_(torch.from_numpy(valid))
                finished = np.ones((b,), bool)
                finished[:len(group)] = False
                remaining = np.zeros((b,), np.int32)
                for i, r in enumerate(group):
                    remaining[i] = r.max_new_tokens
                # Admit before decoding: a request that arrived during the
                # seed prefill may already be admissible into a vacant
                # slot, and the chunk leaves at once (steps=0) if it sees
                # it pending instead.
                continue
            # Refill free slots from the arrived, admissible queue.
            while sched.free_slots():
                cand = next((r for r in queue.arrived(sim)
                             if sched.can_admit(r)), None)
                if cand is None:
                    break
                lb = self._bucket_len(len(cand.prompt))
                offset = sched.pos - lb
                slot_guess = sched.free_slots()[0]
                self._sync()
                t0 = time.monotonic()
                self._admit(cand.prompt, graph, slot_guess, offset)
                self._sync()
                dt = time.monotonic() - t0
                prefill_s += dt
                prefill_calls += 1
                tick(dt, 1)
                slot = sched.admit(cand, sim)
                if slot != slot_guess:
                    raise RuntimeError(
                        f"request {cand.rid} was prefilled into slot "
                        f"{slot_guess} and admitted into slot {slot}")
                queue.pop(cand)
                row = np.zeros((self.max_seq_len,), bool)
                row[offset + (lb - len(cand.prompt)):] = True
                valid[slot] = row
                graph.mask[slot].copy_(torch.from_numpy(row))
                finished[slot] = False
                remaining[slot] = cand.max_new_tokens

            # One chunk of decode.  A live slot always has remaining <=
            # max_seq_len - pos (admission geometry), so steps_cap >= 1.
            live = sched.live_slots()
            steps_cap = min(chunk, self.max_seq_len - sched.pos)
            pending = sum(1 for r in queue.arrived(sim)
                          if sched.can_admit(r))
            graph.pos.fill_(sched.pos)           # each replay advances it
            t0 = time.monotonic()
            steps, out, fin_new, em = self._decode_chunk(
                graph, finished, remaining, eos_id, steps_cap, pending,
                chunk)
            dt = time.monotonic() - t0
            decode_s += dt
            decode_steps += steps
            tick(dt, steps)
            if steps == 0:
                raise RuntimeError(
                    "continuous decode made no progress (scheduler "
                    "invariant violated)")
            for slot in live:
                if em[slot]:
                    sched.note_emitted(slot, out[slot, :em[slot]])
            sched.advance(steps, len(live))
            finished = fin_new
            remaining = remaining - em
            for slot in live:
                if fin_new[slot]:
                    rec = sched.retire(slot, sim)
                    outputs[rec.rid] = np.asarray(rec.tokens, np.int32)
                    if obslog.active():
                        obslog.emit("engine.request", dur_s=rec.latency_s,
                                    rid=rec.rid, slot=rec.slot,
                                    tokens=rec.n_tokens,
                                    prompt_len=rec.prompt_len,
                                    queue_wait_s=rec.queue_wait_s,
                                    admit_s=rec.admit_s,
                                    finish_s=rec.finish_s)

        recs = sched.records
        st = ContinuousStats(
            prefill_s=prefill_s, decode_s=decode_s,
            tokens_out=int(sum(r.n_tokens for r in recs)),
            decode_impl="fused", sim_s=sim, decode_steps=decode_steps,
            prefill_calls=prefill_calls, n_requests=len(recs),
            n_cancelled=sum(1 for r in recs if r.cancelled),
            mean_occupancy=sched.mean_occupancy,
            mean_queue_wait_s=(float(np.mean([r.queue_wait_s
                                              for r in recs]))
                               if recs else 0.0),
            records=recs)
        if obslog.active():
            obslog.emit("engine.prefill", dur_s=prefill_s, batch=b,
                        prompt_len=-1, calls=prefill_calls)
            obslog.emit("engine.decode", dur_s=decode_s, batch=b,
                        tokens=st.tokens_out, decode_impl="fused",
                        tokens_per_s=st.tokens_per_s or None)
        return outputs, st


def _zero_tree(tree) -> None:
    for leaf in tree.values():
        if isinstance(leaf, dict):
            _zero_tree(leaf)
        else:
            leaf.zero_()


def _copy_row(pool, row, slot: int) -> None:
    """pool[...][:, slot] = row[...][:, 0] for every leaf, in place: every
    cache leaf of the port's families carries batch at axis 1."""
    for key, leaf in pool.items():
        if isinstance(leaf, dict):
            _copy_row(leaf, row[key], slot)
        else:
            leaf[:, slot].copy_(row[key][:, 0])


class EngineEnvironment(BaseEnvironment):
    """Camel Environment backed by the real engine: pulling an arm serves
    one batch of synthetic prompts at that batch size and converts the
    measured wall time into an `Observation`; the measured time is scaled
    from the top level to the arm's by the workload's frequency factor.

    Power comes from a pluggable `repro_torch.obs` sensor (`sensor=`
    accepts a `PowerSensor` or a spec string such as ``"nvml"``): each
    pull is wrapped in an `EnergyMeter.measure()` window sampling the
    sensor at `sample_hz`, and the pull's power is the window's average.
    The default (`sensor=None`) evaluates the analytical board model at
    the arm's level and utilization, and the ``"simulated"`` sensor wraps
    that same model, whose constant per-pull reading the meter integrates
    exactly, so both give bit-identical observations.  On the card,
    ``"nvml"`` meters the board's measured power.

    With ``scheduler="continuous"`` a pull serves `requests_per_pull`
    Poisson arrivals (rate = `arrival_rate`, ragged prompt and output
    lengths from `ArrivalProcess`) through `generate_continuous` with the
    batch arm as the slot-pool width, and the Observation carries the
    measured per-request latency, queue wait and goodput instead of the
    analytic queueing model.

    `faults=` (a `repro_torch.faults.FaultPlan`) injects the plan's sensor
    faults into the meter's sensor (`wrap_sensor`) and stamps its
    client-abandonment deadlines on the continuous workload's requests
    (`apply_request_faults`), which `generate_continuous` cancels between
    chunks.  A zero plan is dropped outright, so the run stays
    bit-identical to one without it.  Registry name: "engine/<arch>"."""

    def __init__(self, engine: InferenceEngine, board, work,
                 arrival_rate: float = 1.0, prompt_len: int = 32,
                 max_new_tokens: int = 16, seed: int = 0,
                 sensor=None, sample_hz: float = 20.0,
                 scheduler: str = "static",
                 requests_per_pull: Optional[int] = None,
                 eos_id: Optional[int] = None, chunk: int = 16,
                 faults=None):
        if scheduler not in ("static", "continuous"):
            raise ValueError(f"scheduler must be 'static' or 'continuous', "
                             f"got {scheduler!r}")
        self.engine = engine
        self.board = board
        self.work = work
        self.platform = DVFSPlatform(board)
        self.arrival_rate = require_positive_rate(arrival_rate)
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.scheduler = scheduler
        self.requests_per_pull = requests_per_pull
        self.eos_id = eos_id
        self.chunk = chunk
        self.seed_base = seed
        self.rng = np.random.default_rng(seed)
        self.faults = faults if faults is not None \
            and not faults.is_zero else None
        self.sensor = make_sensor(sensor, platform=self.platform) \
            if sensor is not None else None
        if self.faults is not None and self.sensor is not None:
            self.sensor = wrap_sensor(self.sensor, self.faults)
        self.meter = EnergyMeter(self.sensor, hz=sample_hz) \
            if self.sensor is not None else None

    def _metered(self, util: float, run):
        """`run()` inside a meter window (the sensor first told the
        pull's utilization), or unmetered without a sensor.  Returns
        (run's result, the Measurement or None)."""
        if self.meter is None:
            return run(), None
        set_util = getattr(self.sensor, "set_utilization", None)
        if set_util is not None:
            set_util(util)
        with self.meter.measure() as m:
            result = run()
        return result, m

    @staticmethod
    def _sensor_metadata(metadata: Dict, m) -> None:
        if m is not None:
            metadata.update(sensor=m.sensor_name, sensor_joules=m.joules,
                            sensor_peak_w=m.peak_watts,
                            sensor_samples=m.n_samples)

    def _continuous_workload(self, round_index: int,
                             ) -> List[EngineRequest]:
        """Poisson arrivals with ragged prompt/output lengths, clipped so
        every request fits the engine arena (bucketed prompt +
        max_new_tokens <= max_seq_len)."""
        eng = self.engine
        vocab = eng.bundle.cfg.vocab_size
        n = self.requests_per_pull or 16
        ap = ArrivalProcess(interval_s=1.0 / self.arrival_rate,
                            kind="poisson",
                            prompt_median=self.prompt_len,
                            prompt_max=eng.max_seq_len,
                            max_new_tokens=self.max_new_tokens,
                            seed=self.seed_base + 7919 * (round_index + 1))
        reqs = []
        for r in ap.generate(n):
            mnt = int(self.rng.integers(1, self.max_new_tokens + 1))
            mnt = min(mnt, eng.max_seq_len - eng.prompt_bucket)
            lcap = ((eng.max_seq_len - mnt) // eng.prompt_bucket) \
                * eng.prompt_bucket
            plen = int(np.clip(r.prompt_len, 1, lcap))
            toks = self.rng.integers(1, vocab, size=plen).astype(np.int32)
            reqs.append(EngineRequest(rid=r.rid, prompt=toks,
                                      max_new_tokens=mnt,
                                      arrival_s=r.arrival_s))
        if self.faults is not None:
            reqs = apply_request_faults(reqs, self.faults)
        return reqs

    def _freq_factor(self, level: int) -> float:
        """Service-time scale from the top level to `level`."""
        return self.work.freq_factor(self.board, level) \
            / self.work.freq_factor(self.board, self.board.n_levels - 1)

    def _pull_continuous(self, batch: int, level: int,
                         round_index: int) -> Observation:
        util = self.work.utilization(batch)
        reqs = self._continuous_workload(round_index)
        factor = self._freq_factor(level)
        (_, st), m = self._metered(util, lambda: self.engine
                                   .generate_continuous(
                                       reqs, n_slots=batch,
                                       eos_id=self.eos_id, chunk=self.chunk,
                                       time_scale=factor))
        t_model = st.total_s * factor
        p = self.board.power(level, util) if m is None else m.avg_watts
        joules = p * t_model
        attribute_energy(st.records, joules)
        lat = float(np.mean([r.latency_s for r in st.records]))
        metadata = {"backend": "engine", "scheduler": "continuous",
                    "prefill_s": st.prefill_s, "decode_s": st.decode_s,
                    "decode_impl": st.decode_impl,
                    "tokens_per_s": st.tokens_per_s,
                    "goodput_rps": st.goodput_rps,
                    "n_requests": st.n_requests,
                    "n_cancelled": st.n_cancelled,
                    "decode_steps": st.decode_steps,
                    "mean_occupancy": st.mean_occupancy,
                    "mean_queue_wait_s": st.mean_queue_wait_s}
        self._sensor_metadata(metadata, m)
        # Latency and queue wait are measured on the simulation clock
        # (DVFS-scaled service against real arrival gaps): no analytic
        # queueing model, so the Observation is built directly.
        return Observation(energy=joules / max(st.n_requests, 1),
                           latency=lat, batch_time=t_model,
                           queue_wait=st.mean_queue_wait_s, backlog=0.0,
                           power=p, batch=batch, tokens=st.tokens_out,
                           metadata=metadata)

    def pull(self, knobs: Dict, round_index: int) -> Observation:
        batch = int(knobs["batch"])
        level = self.platform.level_of(knobs["freq_mhz"])
        self.platform.set_level(level)
        if self.scheduler == "continuous":
            return self._pull_continuous(batch, level, round_index)
        util = self.work.utilization(batch)
        vocab = self.engine.bundle.cfg.vocab_size
        prompts = [self.rng.integers(1, vocab, size=self.prompt_len)
                   .astype(np.int32) for _ in range(batch)]
        (_, st), m = self._metered(util, lambda: self.engine.generate(
            prompts, self.max_new_tokens))
        t_batch = st.total_s * self._freq_factor(level)
        p = self.board.power(level, util) if m is None else m.avg_watts
        metadata = {"backend": "engine", "prefill_s": st.prefill_s,
                    "decode_s": st.decode_s,
                    "decode_impl": st.decode_impl,
                    "tokens_per_s": st.tokens_per_s}
        self._sensor_metadata(metadata, m)
        # Single-batch horizon (n_requests = batch): no saturation backlog.
        return observe(p, t_batch, batch, self.arrival_rate,
                       n_requests=batch, tokens=st.tokens_out,
                       metadata=metadata)
