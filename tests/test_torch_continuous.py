"""Continuous batching in the port (`serving/scheduler.py`,
`InferenceEngine.generate_continuous`), on the CPU, held against the JAX
package.

- The scheduler: tests/test_continuous.py's `simulate` harness drives the
  reference's `SlotScheduler` and the port's copy through the same
  hypothesis workloads (deadlines included); the records are identical.
- The JAX engine: on shared fp32 weights (`params_from_jax`), a staggered
  workload with `step_time_s=1.0`, an admission mid-decode and an EOS
  gives every rid's stream, `decode_steps`, `prefill_calls` and each
  record's slot, `admit_s` and `finish_s` equal to the JAX engine's, for
  the four families; recurrentgemma's with a prompt bucket of 4, so an
  admitted prompt shorter than its 8-slot ring window is rolled into the
  ring at its offset.
- Restated from tests/test_engine_fused.py on the port's four families
  (smoke configs, fp32): no-churn continuous ≡ static `generate` at
  chunk 8 and chunk 3; a request's stream independent of its
  co-residents (llama, and recurrentgemma's ring); EOS early exit in <= 2
  steps; the validation messages; `compile_counts` flat over an
  occupancy sweep; `EngineEnvironment(scheduler="continuous")` metadata
  keys equal to the reference's.

The card's side (continuous identity with the graph ≡ the eager loop) is
in tests/test_torch_cuda.py.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_continuous as harness
import torch
from hypothesis import given, settings

import repro.configs as jax_configs
import repro.serving.scheduler as ref_scheduler
import repro_torch.configs as torch_configs
from repro.models.registry import bundle_for as jax_bundle_for
from repro.platform import make_env as jax_make_env
from repro.serving.engine import InferenceEngine as JaxEngine
from repro_torch.models.registry import bundle_for
from repro_torch.platform import make_env
from repro_torch.serving import scheduler as port_scheduler
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.scheduler import EngineRequest

ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "rwkv6-3b", "recurrentgemma-9b")
#: The recurrentgemma smoke's attention ring holds 8 slots; a prompt
#: bucket of 4 lets an admitted prompt be shorter than the ring.
RING_BUCKET = 4
MAX_LEN = 64


# ---------------------------------------------------------------------------
# The scheduler against the reference's, through the reference's harness
# ---------------------------------------------------------------------------


def _simulate(module, workload):
    """tests/test_continuous.py's `simulate` with `module`'s scheduler
    classes.  Returns what the run decided: every record, the total
    tokens, the clock and the mean occupancy."""
    with mock.patch.object(harness, "SlotScheduler",
                           module.SlotScheduler), \
            mock.patch.object(harness, "RequestQueue", module.RequestQueue):
        sched, total = harness.simulate(*workload)
    module.attribute_energy(sched.records, 17.3)
    return ([dataclasses.asdict(r) for r in sched.records], total,
            sched.pos, sched.mean_occupancy)


@given(harness.workloads())
@settings(max_examples=40, deadline=None)
def test_scheduler_records_equal_the_reference(workload):
    assert _simulate(port_scheduler, workload) == \
        _simulate(ref_scheduler, workload)


@given(harness.deadline_workloads())
@settings(max_examples=40, deadline=None)
def test_scheduler_records_with_deadlines_equal_the_reference(workload):
    assert _simulate(port_scheduler, workload) == \
        _simulate(ref_scheduler, workload)


# ---------------------------------------------------------------------------
# The engine against the JAX engine on shared weights
# ---------------------------------------------------------------------------


def _models(arch):
    """JAX bundle + params and the port's bundle + the same params, fp32."""
    jcfg = dataclasses.replace(jax_configs.get_smoke(arch),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(torch_configs.get_smoke(arch),
                               dtype=torch.float32)
    jb, tb = jax_bundle_for(jcfg), bundle_for(tcfg)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    tparams = tb.module.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return jb, jparams, tb, tparams


def _engine(arch, **kw):
    """The port's engine on the arch's smoke config, fp32, on the CPU."""
    cfg = dataclasses.replace(torch_configs.get_smoke(arch),
                              dtype=torch.float32)
    bundle = bundle_for(cfg)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq_len", MAX_LEN)
    return InferenceEngine(bundle, bundle.init_params(0, "cpu"),
                           device="cpu", **kw)


def _prompts(lengths, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32)
            for n in lengths]


#: (prompt length, budget, arrival) of the staggered workload: two seeds,
#: then arrivals while they decode; the 3-token prompt is shorter than
#: recurrentgemma's ring at a bucket of 4.
STAGGERED = ((5, 12, 0.0), (9, 4, 0.0), (13, 6, 0.5), (3, 5, 2.5),
             (20, 3, 3.0))


def _staggered(request_cls, prompts):
    return [request_cls(rid=i, prompt=p, max_new_tokens=m, arrival_s=a)
            for i, (p, (_, m, a)) in enumerate(zip(prompts, STAGGERED))]


def _mid_decode_admissions(records):
    """Records admitted while another request was live in another
    slot."""
    return [r for r in records if r.slot >= 0 and any(
        o.slot != r.slot and o.admit_s < r.admit_s < o.finish_s
        for o in records)]


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_matches_the_jax_engine(arch):
    bucket = RING_BUCKET if arch == "recurrentgemma-9b" else 16
    jb, jp, tb, tp = _models(arch)
    prompts = _prompts([n for n, _, _ in STAGGERED], seed=3)
    port = InferenceEngine(tb, tp, max_batch=4, max_seq_len=MAX_LEN,
                           prompt_bucket=bucket, device="cpu")
    # The EOS: the third token request 0 emits without one.
    free, _ = port.generate_continuous(
        _staggered(EngineRequest, prompts), n_slots=2, chunk=4,
        step_time_s=1.0)
    eos = int(free[0][2])
    kw = dict(n_slots=2, chunk=4, step_time_s=1.0, eos_id=eos)
    out, st = port.generate_continuous(
        _staggered(EngineRequest, prompts), **kw)
    ref_out, ref_st = JaxEngine(
        jb, jp, max_batch=4, max_seq_len=MAX_LEN,
        prompt_bucket=bucket).generate_continuous(
        _staggered(ref_scheduler.EngineRequest, prompts), **kw)

    assert out.keys() == ref_out.keys()
    for rid in ref_out:
        np.testing.assert_array_equal(out[rid], ref_out[rid],
                                      err_msg=f"{arch} request {rid}")
    assert (st.decode_steps, st.prefill_calls, st.sim_s) == \
        (ref_st.decode_steps, ref_st.prefill_calls, ref_st.sim_s)
    assert [(r.rid, r.slot, r.admit_s, r.finish_s, r.n_tokens, r.tokens)
            for r in st.records] == \
        [(r.rid, r.slot, r.admit_s, r.finish_s, r.n_tokens, r.tokens)
         for r in ref_st.records]
    # The workload did what it is for: an EOS cut request 0 short, and a
    # request joined a live pool.
    assert out[0][-1] == eos and len(out[0]) < STAGGERED[0][1]
    assert _mid_decode_admissions(st.records)
    assert st.mean_occupancy == ref_st.mean_occupancy


# ---------------------------------------------------------------------------
# The reference's own invariants, restated on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_identity_matches_static(arch):
    """Every request at t=0, equal budgets and no EOS: the continuous
    schedule is the static one (one seed prefill, no admission, no early
    exit), so the streams equal `generate`'s bit for bit; chunk 3 splits
    the 8 steps 3 + 3 + 2."""
    eng = _engine(arch)
    prompts = _prompts([5, 9, 7])
    out_s, _ = eng.generate(prompts, max_new_tokens=8)
    for chunk in (8, 3):
        reqs = [EngineRequest(rid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
        out_c, st = eng.generate_continuous(reqs, n_slots=3, chunk=chunk)
        assert st.decode_steps == 8 and st.prefill_calls == 1
        for i in range(3):
            np.testing.assert_array_equal(
                out_c[i], out_s[i],
                err_msg=f"{arch} chunk={chunk} request {i}")


@pytest.mark.parametrize("arch,bucket", [("llama3.2-1b", 16),
                                         ("recurrentgemma-9b", RING_BUCKET)])
def test_continuous_stream_independent_of_co_residents(arch, bucket):
    """A long request beside churning short ones (admissions into the
    neighbouring slot, recurrentgemma's shorter than its ring window)
    emits the stream it emits alone."""
    eng = _engine(arch, prompt_bucket=bucket)
    prompts = _prompts([5, 7, 3, 2], seed=3)
    reqs = [EngineRequest(rid=0, prompt=prompts[0], max_new_tokens=20),
            EngineRequest(rid=1, prompt=prompts[1], max_new_tokens=4),
            EngineRequest(rid=2, prompt=prompts[2], max_new_tokens=6,
                          arrival_s=0.5),
            EngineRequest(rid=3, prompt=prompts[3], max_new_tokens=5,
                          arrival_s=6.0)]
    out_c, st = eng.generate_continuous(reqs, n_slots=2, chunk=4,
                                        step_time_s=1.0)
    assert st.prefill_calls == 3      # one seed, two admissions
    assert len(_mid_decode_admissions(st.records)) == 2
    # Request 0 alone, left-padded as in the seed batch (a recurrent
    # state folds its pads in).
    solo, _ = eng.generate([prompts[0]], max_new_tokens=20)
    if bucket == RING_BUCKET:
        solo, _ = _engine(arch, prompt_bucket=8).generate(
            [prompts[0]], max_new_tokens=20)
    np.testing.assert_array_equal(out_c[0], solo[0])
    assert [len(out_c[i]) for i in (1, 2, 3)] == [4, 6, 5]


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_eos_early_exit(arch):
    """A batch whose first decode token is EOS finishes in <= 2 decode
    steps, not its 24-token budget."""
    eng = _engine(arch)
    prompt = _prompts([6], seed=4)[0]
    probe, _ = eng.generate([prompt] * 4, max_new_tokens=1)
    eos = int(probe[0, 0])
    reqs = [EngineRequest(rid=i, prompt=prompt, max_new_tokens=24)
            for i in range(4)]
    out, st = eng.generate_continuous(reqs, n_slots=4, eos_id=eos,
                                      chunk=24)
    assert st.decode_steps <= 2, \
        f"early exit took {st.decode_steps} steps (cap 24)"
    for i in range(4):
        assert out[i][-1] == eos


def test_continuous_validation_errors():
    eng = _engine("llama3.2-1b", max_batch=2, max_seq_len=48)
    p = _prompts([4])[0]
    ok = EngineRequest(rid=0, prompt=p, max_new_tokens=4)
    with pytest.raises(ValueError, match="at least one"):
        eng.generate_continuous([])
    with pytest.raises(ValueError, match="duplicate"):
        eng.generate_continuous(
            [ok, EngineRequest(rid=0, prompt=p, max_new_tokens=2)])
    with pytest.raises(ValueError, match="empty prompt"):
        eng.generate_continuous(
            [EngineRequest(rid=1, prompt=np.zeros(0, np.int32),
                           max_new_tokens=2)])
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate_continuous(
            [EngineRequest(rid=2, prompt=p, max_new_tokens=40)])
    with pytest.raises(ValueError, match="eos_id"):
        eng.generate_continuous([ok], eos_id=-5)
    with pytest.raises(ValueError, match="chunk"):
        eng.generate_continuous([ok], chunk=0)
    with pytest.raises(ValueError, match="n_slots"):
        eng.generate_continuous([ok], n_slots=5)


def test_continuous_occupancy_sweep_keeps_compile_counts_flat():
    """After one warm-up covering the shapes (seed prefill, one-row
    admission, the pool's decode step), workloads whose occupancy drains
    from full to one keep `compile_counts` flat: one decode step at the
    pool's width, shared with the static path."""
    eng = _engine("llama3.2-1b")

    def serve(seed, budgets, stagger):
        prompts = _prompts([5, 9, 13, 7], seed=seed)
        reqs = [EngineRequest(rid=i, prompt=p, max_new_tokens=m,
                              arrival_s=stagger * i)
                for i, (p, m) in enumerate(zip(prompts, budgets))]
        eng.generate_continuous(reqs, n_slots=4, chunk=4, step_time_s=1.0)

    serve(0, [16, 8, 4, 2], stagger=0.0)   # drain: 4 live -> 1 live
    serve(1, [12, 3, 5, 2], stagger=2.0)   # admission mid-generate
    baseline = dict(eng.compile_counts)
    assert baseline["decode_fused"] == 1 and baseline["admit"] == 1
    for s in range(2, 7):
        serve(s, [2 + 3 * s % 13, 16, 5, 8], stagger=0.5 * (s % 3))
        assert eng.compile_counts == baseline, \
            f"new shape at sweep {s}: {eng.compile_counts} != {baseline}"
    eng.generate(_prompts([5, 9, 13, 7]), max_new_tokens=4)
    assert eng.compile_counts == baseline


def test_engine_env_continuous_metadata_matches_the_reference():
    """The continuous environment reports measured goodput, queue wait
    and occupancy, under the reference's metadata keys."""
    kw = dict(seed=0, prompt_len=8, max_new_tokens=4, max_batch=4,
              max_seq_len=32, scheduler="continuous", requests_per_pull=4,
              arrival_rate=4.0)
    env = make_env("engine/llama3.2-1b", device="cpu", **kw)
    ref = jax_make_env("engine/llama3.2-1b", **kw)
    knobs = {"freq_mhz": 930.75, "batch": 2}
    obs, ref_obs = env.pull(knobs, 0), ref.pull(knobs, 0)
    assert obs.metadata.keys() == ref_obs.metadata.keys()
    md = obs.metadata
    assert md["scheduler"] == "continuous" and md["n_requests"] == 4
    assert md["goodput_rps"] > 0 and 0 < md["mean_occupancy"] <= 2
    assert obs.energy > 0 and obs.latency > 0
    assert obs.queue_wait == md["mean_queue_wait_s"]
    # The same Poisson workload on both sides.
    assert md["n_requests"] == ref_obs.metadata["n_requests"]
    assert obs.tokens == ref_obs.tokens
