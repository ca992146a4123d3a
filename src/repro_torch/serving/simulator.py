"""Serving simulators for the Camel controller — the Jetson half of
`repro.serving.simulator` in the port.

Every environment implements the `repro_torch.platform` contract: `pull`
returns a rich `Observation` (energy/request, latency decomposition, mean
power, tokens) computed through the one shared queueing-latency model, and
carries a `platform` adapter.  Construct them by name through
`repro_torch.platform.make_env` ("jetson/llama3.2-1b/landscape",
"jetson/.../events").  The figures are the modelled Jetson AGX Orin
(`serving.energy`), not measurements of the card the port runs on.

Three levels of fidelity:

* `LandscapeEnv` — closed-form expected Observation per arm +
  multiplicative observation noise: the paper's configuration search
  (Results 1).  Its batched `pull_many` evaluates the K slots of a round
  in one fp32 PyTorch evaluation on the env's device (CUDA unless the
  caller passes ``device="cpu"``); sequential `pull` and `expected` keep
  the f64 scalar path, and the noise stream is the seeded numpy generator
  on both paths.
* `EventEnvironment` — each pull replays a short arrival trace through
  the discrete-event server at the pulled config and reports the measured
  telemetry.
* `EventDrivenServer` — the discrete-event simulation itself: requests
  arrive, a FIFO batcher accumulates them, the server processes batches
  in sequence, and a tuner may re-tune (frequency, batch) between
  batches: the paper's validation (Results 2).

The reference's TPU environments are not ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.arms import ArmSpace
from repro_torch.platform import (BaseEnvironment, DVFSPlatform, Observation,
                                  observe)
from repro_torch.serving.energy import DVFSBoard, WorkloadModel
from repro_torch.serving.queueing import FIFOBatcher, require_positive_rate
from repro_torch.serving.requests import ArrivalProcess, Request


# ---------------------------------------------------------------------------
# Closed-form environment (configuration search experiments)
# ---------------------------------------------------------------------------


def _jetson_batch_eval(levels: torch.Tensor, batches: torch.Tensor,
                       consts: torch.Tensor, n_levels: int):
    """The closed form of `LandscapeEnv.expected` over K arms in fp32, on
    the device of its inputs: Eq. 2 power, Eq. 3 batch time, Eq. 5 energy,
    Eq. 7 + backlog latency.  `consts` holds the board's frequencies and
    voltages (n_levels each) then p_static, c_eff, t_unit, c0, kappa, pu,
    b_ref, work_scale, arrival_rate and n_requests, each rounded to fp32
    as the reference's jitted form takes them.  Returns f32[6, K]:
    energy, latency, batch time, queue wait, backlog, power."""
    freqs, volts = consts[:n_levels], consts[n_levels:2 * n_levels]
    (p_static, c_eff, t_unit, c0, kappa, pu, b_ref, work_scale,
     arrival_rate, n_requests) = consts[2 * n_levels:]
    f = freqs[levels]
    v = volts[levels]
    util = (batches / b_ref) ** pu
    p = p_static + c_eff * v * v * (f / 1000.0) * util
    ff = kappa + (1.0 - kappa) * freqs[-1] / f
    tb = t_unit * (c0 + work_scale * batches) * ff
    wait = (batches - 1.0) / (2.0 * arrival_rate)
    n_batches = torch.ceil(n_requests / batches)
    backlog = (tb - batches / arrival_rate).clamp_min(0.0) \
        * (n_batches - 1.0) / 2.0
    energy = p * tb / batches
    latency = wait + tb + backlog
    return torch.stack([energy, latency, tb, wait, backlog, p])


class LandscapeEnv(BaseEnvironment):
    """Expected landscape + multiplicative lognormal noise.

    Knobs: {'freq_mhz': level value, 'batch': int}.  `device` is where
    `pull_many` evaluates (CUDA unless given; `"cpu"` for the plain
    path).
    """

    round_independent = True

    def __init__(self, board: DVFSBoard, work: WorkloadModel,
                 arrival_rate: float = 1.0, n_requests: int = 2500,
                 noise: float = 0.03, seed: int = 0,
                 work_scale: float = 1.0, device=None):
        self.board = board
        self.work = work
        self.platform = DVFSPlatform(board)
        self.arrival_rate = require_positive_rate(arrival_rate)
        self.n_requests = n_requests
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.work_scale = work_scale
        self.device = resolve_device(device)
        w = work
        self._consts = torch.tensor(
            [*board.freqs_mhz, *board.voltages, board.p_static, board.c_eff,
             w.t_unit, w.c0_units, w.kappa, w.pu, float(w.b_ref),
             work_scale, self.arrival_rate, float(n_requests)],
            dtype=torch.float32, device=self.device)

    def expected(self, knobs: Dict) -> Observation:
        level = self.platform.level_of(knobs["freq_mhz"])
        b = int(knobs["batch"])
        p = self.board.power(level, self.work.utilization(b))
        tb = self.work.batch_time(self.board, level, b, self.work_scale)
        return observe(p, tb, b, self.arrival_rate, self.n_requests,
                       tokens=b * self.work.tokens_out,
                       metadata={"backend": "jetson-landscape",
                                 "level": level})

    def pull(self, knobs: Dict, round_index: int) -> Observation:
        self.platform.set_level(self.platform.level_of(knobs["freq_mhz"]))
        obs = self.expected(knobs)
        if self.noise > 0:
            obs = obs.scaled(
                float(np.exp(self.noise * self.rng.standard_normal())),
                float(np.exp(self.noise * self.rng.standard_normal())))
        return obs

    def pull_many(self, knobs_list: Sequence[dict], round_index: int = 0
                  ) -> List[Observation]:
        """Batched pull: one fp32 evaluation of all K slots on the env's
        device (sequential `pull` keeps the f64 scalar path, so the two
        agree to fp32 precision, not bit for bit).  The landscape is
        round-independent, and the noise stream advances exactly as K
        sequential pulls would (the (K, 2) normal draw consumes the same
        generator sequence)."""
        del round_index
        levels = [self.platform.level_of(k["freq_mhz"]) for k in knobs_list]
        batches = [int(k["batch"]) for k in knobs_list]
        out = _jetson_batch_eval(
            torch.tensor(levels, dtype=torch.long, device=self.device),
            torch.tensor(batches, dtype=torch.float32, device=self.device),
            self._consts, self.board.n_levels)
        e, l, tb, wait, backlog, p = out.cpu().numpy().astype(np.float64)
        if self.noise > 0:
            z = self.rng.standard_normal((len(knobs_list), 2))
            e = e * np.exp(self.noise * z[:, 0])
            l = l * np.exp(self.noise * z[:, 1])
        self.platform.set_level(levels[-1])
        work = self.work
        return [Observation(
            energy=float(e[i]), latency=float(l[i]), batch_time=float(tb[i]),
            queue_wait=float(wait[i]), backlog=float(backlog[i]),
            power=float(p[i]), batch=batches[i],
            tokens=batches[i] * work.tokens_out,
            metadata={"backend": "jetson-landscape", "level": levels[i],
                      "vectorized": True})
            for i in range(len(knobs_list))]


# ---------------------------------------------------------------------------
# Event-driven simulation (validation experiments)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchStats:
    bid: int
    size: int
    freq_mhz: float
    ready_s: float
    start_s: float
    finish_s: float
    batch_time_s: float
    energy_per_req: float
    mean_latency_s: float


@dataclasses.dataclass
class ServeResult:
    batches: List[BatchStats]
    request_latencies: np.ndarray
    request_energies: np.ndarray

    def summary(self) -> dict:
        e = self.request_energies
        l = self.request_latencies
        return {
            "n_requests": int(len(l)),
            "energy_per_req": float(e.mean()),
            "latency_per_req": float(l.mean()),
            "edp": float(e.mean() * l.mean()),
            "p50_latency": float(np.percentile(l, 50)),
            "p99_latency": float(np.percentile(l, 99)),
        }


class EventDrivenServer:
    """Sequential-batch server over a concrete arrival trace.

    `tuner(batch_index, server)` -> {'freq_mhz': ..., 'batch': ...} is called
    before each batch is formed; pass a constant dict for fixed-config
    validation, or an `OnlineCamelTuner` for online Camel.  If the tuner
    exposes an `observe(energy, latency)` method the server feeds each
    batch's measured stats back after processing it — the closed loop of
    the paper's Fig. 2.
    """

    def __init__(self, board: DVFSBoard, work: WorkloadModel,
                 arrivals: ArrivalProcess, n_requests: int,
                 noise: float = 0.02, seed: int = 0):
        self.board = board
        self.work = work
        self.requests = list(arrivals.generate(n_requests))
        self.noise = noise
        self.rng = np.random.default_rng(seed)

    def run(self, tuner) -> ServeResult:
        batcher = FIFOBatcher()
        pending = list(self.requests)
        pending.reverse()           # pop from the end = earliest first
        server_free_at = 0.0
        batches: List[BatchStats] = []
        lat: List[float] = []
        en: List[float] = []
        bi = 0
        feedback = getattr(tuner, "observe", None)

        while pending or len(batcher):
            knobs = tuner(bi, self)
            level = self.board.level_of(float(knobs["freq_mhz"]))
            bsize = int(knobs["batch"])

            # Admit arrivals until the batch can be formed.
            batch = batcher.try_pop_batch(min(bsize, len(batcher) +
                                              len(pending)))
            while batch is None:
                if not pending:
                    # Tail: serve the remainder as a final smaller batch.
                    rem = batcher.drain()
                    if not rem:
                        break
                    ready = max(r.arrival_s for r in rem)
                    batch = _manual_batch(bi, rem, ready)
                    break
                batcher.add(pending.pop())
                batch = batcher.try_pop_batch(bsize)
            if batch is None:
                break

            tb = self.work.batch_time(self.board, level, batch.size)
            if self.noise > 0:
                tb *= float(np.exp(self.noise * self.rng.standard_normal()))
            p = self.board.power(level, self.work.utilization(batch.size))
            start = max(batch.ready_s, server_free_at)
            finish = start + tb
            server_free_at = finish
            e_req = p * tb / batch.size
            mean_lat = float(np.mean(
                [finish - r.arrival_s for r in batch.requests]))

            for r in batch.requests:
                lat.append(finish - r.arrival_s)
                en.append(e_req)
            batches.append(BatchStats(
                bid=batch.bid, size=batch.size,
                freq_mhz=self.board.freqs_mhz[level], ready_s=batch.ready_s,
                start_s=start, finish_s=finish, batch_time_s=tb,
                energy_per_req=e_req, mean_latency_s=mean_lat))
            if feedback is not None:
                feedback(e_req, mean_lat)
            bi += 1

        return ServeResult(batches=batches,
                           request_latencies=np.asarray(lat),
                           request_energies=np.asarray(en))


def _manual_batch(bid: int, reqs: List[Request], ready: float):
    from repro_torch.serving.queueing import Batch
    return Batch(bid=bid, requests=reqs, ready_s=ready)


def fixed_config_tuner(freq_mhz: float, batch: int):
    knobs = {"freq_mhz": freq_mhz, "batch": batch}
    return lambda bi, server: knobs


class EventEnvironment(BaseEnvironment):
    """Pull-style adapter over the event-driven simulator: each pull serves
    a short arrival trace at the pulled (frequency, batch) config and
    reports the measured telemetry as an Observation.  Same contract as
    `LandscapeEnv`, but queue wait and saturation backlog *emerge* from the
    discrete-event loop rather than from the closed form — this is the
    registry's "jetson/<model>/events" scenario.  Host code: nothing runs
    on a device.
    """

    def __init__(self, board: DVFSBoard, work: WorkloadModel,
                 interval_s: float = 1.0, requests_per_pull: int = 120,
                 noise: float = 0.02, seed: int = 0):
        self.board = board
        self.work = work
        self.platform = DVFSPlatform(board)
        self.interval_s = require_positive_rate(
            interval_s, knob="interval_s", unit="seconds/request")
        self.requests_per_pull = requests_per_pull
        self.noise = noise
        self.seed = seed

    def pull(self, knobs: Dict, round_index: int) -> Observation:
        level = self.platform.level_of(knobs["freq_mhz"])
        self.platform.set_level(level)
        b = int(knobs["batch"])
        trace_seed = self.seed + round_index
        server = EventDrivenServer(
            self.board, self.work,
            ArrivalProcess(interval_s=self.interval_s, seed=trace_seed),
            self.requests_per_pull, noise=self.noise, seed=trace_seed)
        res = server.run(fixed_config_tuner(float(knobs["freq_mhz"]), b))
        s = res.summary()
        # Exact per-request latency decomposition from the trace:
        # finish - arrival = (ready - arrival) + (start - ready) + t_batch,
        # so the request-weighted means satisfy latency = wait + backlog + bt
        # and backlog > 0 only when the server actually delayed batches.
        sizes = np.array([bs.size for bs in res.batches], dtype=float)
        weights = sizes / sizes.sum() if len(sizes) else sizes
        bt = float(np.dot(weights,
                          [bs.batch_time_s for bs in res.batches]))
        backlog = float(np.dot(weights,
                               [bs.start_s - bs.ready_s
                                for bs in res.batches]))
        return Observation(
            energy=s["energy_per_req"],
            latency=s["latency_per_req"],
            batch_time=bt,
            queue_wait=s["latency_per_req"] - bt - backlog,
            backlog=backlog,
            power=self.board.power(level, self.work.utilization(b)),
            batch=b,
            tokens=s["n_requests"] * self.work.tokens_out,
            metadata={"backend": "jetson-events",
                      "n_batches": len(res.batches),
                      "p99_latency": s["p99_latency"]})


class OnlineCamelTuner:
    """Wraps a bandit policy as an EventDrivenServer tuner.  The server
    calls `observe` with each processed batch's measured (energy,
    latency), updating the posterior before the next arm is chosen — the
    closed loop of the paper's Fig. 2.  Selection draws from a
    `torch.Generator` seeded with `seed`."""

    def __init__(self, space: ArmSpace, policy, cost_model, seed: int = 0):
        self.space = space
        self.policy = policy
        self.cost_model = cost_model
        self.state = policy.init(space.n_arms)
        self.gen = torch.Generator().manual_seed(seed)
        self._last_arm: Optional[int] = None
        self._observations: List[Tuple[int, float]] = []

    def observe(self, energy: float, latency: float) -> None:
        if self._last_arm is None:
            return
        cost = float(self.cost_model.cost(energy, latency))
        self.state = self.policy.update(self.state, self._last_arm, cost)
        self._observations.append((self._last_arm, cost))

    def __call__(self, bi: int, server) -> Dict:
        arm = int(self.policy.select(self.state, self.gen, bi + 1))
        self._last_arm = arm
        return self.space.values(arm)
