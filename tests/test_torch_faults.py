"""Fault injection in the port (`repro_torch.faults`) against the JAX
package's (`repro.faults`), on the CPU.

- The plan: `parse_faults` over the whole grammar and every error, field
  for field; every decision (`pull_fault`, `backoff`, `sensor_fault`,
  `request_deadline`) equal to the reference's bit for bit over a grid of
  identities (each is a numpy draw in both packages).
- The injectors: `FlakySensor`'s sequence is the reference's, zero-plan
  wraps are no-ops, `FaultyFleet` redispatches crashed devices' slots and
  inflates throttled devices' durations.
- The fleet under chaos: the deterministic grid policy on the 4-device
  fleet under E14's two chaos specs gives the reference's records,
  `failed_pulls` and retries record by record.
- E14's four claims restated on the port (seed 0, Camel with the analytic
  prior): a zero plan and an idle armed plan are bit-for-bit no-ops, the
  chaos runs spend their exact budget and commit within 5 % of the clean
  commit, a hung device times out and is quarantined, and the engine's
  zero plan leaves its streams as they were.
- Request cancellation: `generate_continuous` under a cancel plan gives
  the JAX engine's streams and records (`cancelled`, tokens, `finish_s`)
  on llama3.2-1b-smoke and on rwkv6-smoke (whose recurrent state a
  cancelled slot's refill must not inherit), each cancelled request
  stopping no later than the next chunk boundary after its deadline.
- `serve.py --faults` prints the reference's keys and `faults`.
"""

import dataclasses
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.configs as jax_configs
import repro.faults as jax_faults
import repro_torch.configs as torch_configs
import torch
from repro import obs as jax_obs
from repro.core import baselines as jax_baselines
from repro.core import controller as jax_controller
from repro.launch import serve as jax_serve
from repro.models.registry import bundle_for as jax_bundle_for
from repro.obs.sensors import SensorUnavailable as JaxSensorUnavailable
from repro.platform import make_env as jax_make_env
from repro.platform import make_space as jax_make_space
from repro.serving.engine import InferenceEngine as JaxEngine
from repro.serving.scheduler import EngineRequest as JaxRequest
from repro_torch import faults, obs
from repro_torch.core import baselines, controller, cost, priors
from repro_torch.launch import serve
from repro_torch.models.registry import bundle_for
from repro_torch.obs.sensors import SensorUnavailable
from repro_torch.platform import PullFault, make_env, make_space
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.scheduler import EngineRequest

FLEET = "fleet/4xjetson/llama3.2-1b/landscape"
#: E14's constants (the reference's benchmarks/resilience.py:50-58).
K, PULLS, TOL = 4, 64, 0.05
CHAOS_SPEC = "pull_fail=0.2,crash=0@4,deadline=4,retries=3,seed=1"
CENSORED_SPEC = "pull_fail=0.35,crash=0@4,deadline=4,retries=1,seed=1"

FULL_SPEC = ("pull_fail=0.2, crash=1@3, crash=0@5, throttle=0@5x2.5,"
             "throttle=2@1, sensor_drop=0.1, sensor_nan=0.05, "
             "cancel=0.1@4.0, deadline=3, retries=4, backoff=0.1, seed=42")


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    None, "", "  ", "none", FULL_SPEC, "deadline=4", "retries=5",
    "cancel=0.3", "cancel=1@0.5", "crash=2@0,crash=3@7", "seed=-3",
    "pull_fail=1.0,,sensor_nan=0"])
def test_parse_faults_matches_the_reference(spec):
    plan, ref = faults.parse_faults(spec), jax_faults.parse_faults(spec)
    assert dataclasses.asdict(plan) == dataclasses.asdict(ref)
    assert plan.is_zero == ref.is_zero


@pytest.mark.parametrize("spec", [
    "explode=1", "pull_fail", "crash=zero@3", "crash=1", "throttle=0@x2",
    "throttle=0@2xfast", "pull_fail=1.5", "sensor_drop=-0.1",
    "cancel=2@1", "cancel=0.5@soon", "retries=two", "deadline=far"])
def test_parse_faults_errors_match_the_reference(spec):
    with pytest.raises(ValueError) as ref:
        jax_faults.parse_faults(spec)
    with pytest.raises(ValueError) as port:
        faults.parse_faults(spec)
    assert str(port.value) == str(ref.value)


def test_plan_decisions_equal_the_reference_bit_for_bit():
    spec = dict(seed=7, pull_fail=0.4, sensor_drop=0.2, sensor_nan=0.1,
                cancel=0.3, cancel_patience_s=2.5, backoff_factor=0.07,
                crashes=((1, 3),), throttles=((0, 2, 2.0), (0, 5, 1.5)))
    plan, ref = faults.FaultPlan(**spec), jax_faults.FaultPlan(**spec)
    for ticket in range(0, 300, 7):
        for worker in range(4):
            for attempt in (1, 2, 3):
                args = (ticket, worker, attempt, ticket % 9)
                assert plan.pull_fault(*args) == ref.pull_fault(*args)
        for attempt in range(1, 6):
            assert plan.backoff(ticket, attempt) == \
                ref.backoff(ticket, attempt)
    for i in range(500):
        assert plan.sensor_fault(i) == ref.sensor_fault(i)
    for rid in range(200):
        assert plan.request_deadline(rid, 0.5 * rid) == \
            ref.request_deadline(rid, 0.5 * rid)
    for dev in range(4):
        for rnd in range(8):
            assert plan.throttle_factor(dev, rnd) == \
                ref.throttle_factor(dev, rnd)
            assert plan.device_crashed(dev, rnd) == \
                ref.device_crashed(dev, rnd)
    # The draws are not degenerate: every kind of decision occurs.
    assert {plan.sensor_fault(i) for i in range(200)} == {None, "drop",
                                                         "nan"}
    assert {plan.pull_fault(t, 2, 1, 0) for t in range(50)} == {None,
                                                               "flaky"}


# ---------------------------------------------------------------------------
# The injectors
# ---------------------------------------------------------------------------

class _ConstSensor:
    name = "const"

    def __init__(self):
        self.closed = False

    def read_watts(self):
        return 5.0

    def close(self):
        self.closed = True


def _reads(sensor, unavailable, n=200):
    out = []
    for _ in range(n):
        try:
            w = sensor.read_watts()
            out.append("nan" if math.isnan(w) else w)
        except unavailable:
            out.append("drop")
    return out


def test_flaky_sensor_sequence_is_the_references():
    spec = dict(seed=3, sensor_drop=0.3, sensor_nan=0.2)
    port = faults.FlakySensor(_ConstSensor(), faults.FaultPlan(**spec))
    ref = jax_faults.FlakySensor(_ConstSensor(),
                                 jax_faults.FaultPlan(**spec))
    seq = _reads(port, SensorUnavailable)
    assert seq == _reads(ref, JaxSensorUnavailable)
    again = faults.FlakySensor(_ConstSensor(), faults.FaultPlan(**spec))
    assert _reads(again, SensorUnavailable) == seq       # replayable
    assert {"drop", "nan", 5.0} == set(seq)
    assert port.faults_injected == ref.faults_injected == \
        seq.count("drop") + seq.count("nan")
    assert port.name == "flaky:const"
    port.close()
    assert port._inner.closed


def test_zero_plan_wraps_are_noops():
    zero = faults.FaultPlan()
    sensor = _ConstSensor()
    assert faults.wrap_sensor(sensor, zero) is sensor
    assert faults.wrap_sensor(None, zero) is None
    env = make_env(FLEET, noise=0.0, seed=0, device="cpu")
    assert faults.wrap_env(env, zero) is env
    plain = make_env("jetson/llama3.2-1b/landscape", noise=0.0, seed=0,
                     device="cpu")
    assert faults.wrap_env(plain, faults.FaultPlan(pull_fail=0.5)) is plain
    reqs = [EngineRequest(rid=i, prompt=np.ones(4, np.int32),
                          max_new_tokens=4) for i in range(3)]
    assert all(a is b for a, b in zip(
        faults.apply_request_faults(reqs, zero), reqs))


def test_faulty_fleet_redispatch_and_throttle():
    space = make_space(FLEET)
    env = faults.wrap_env(make_env(FLEET, noise=0.0, seed=0, device="cpu"),
                          faults.FaultPlan(crashes=((0, 0),)))
    assert isinstance(env, faults.FaultyFleet)
    obs_ = env.pull_many([space.values(i) for i in range(4)], round_index=0)
    assert [o.metadata["device"] for o in obs_] == [1, 1, 2, 3]
    assert env.pull(space.values(2), 0).metadata["device"] == 1
    with pytest.raises(PullFault, match="crash"):
        env.pull_on(0, space.values(2), 0)
    dead = faults.wrap_env(
        make_env(FLEET, noise=0.0, seed=0, device="cpu"),
        faults.FaultPlan(crashes=tuple((d, 0) for d in range(4))))
    with pytest.raises(PullFault, match="crash"):
        dead.pull_many([space.values(0)], round_index=0)

    bare = make_env(FLEET, noise=0.0, seed=0, device="cpu")
    slow = faults.wrap_env(make_env(FLEET, noise=0.0, seed=0, device="cpu"),
                           faults.FaultPlan(throttles=((1, 2, 3.0),)))
    base = bare.pull_duration(1)
    assert isinstance(base, float)
    assert slow.pull_duration(1, 0) == base
    assert slow.pull_duration(1, 2) == 3.0 * base
    assert slow.pull_duration(0, 99) == bare.pull_duration(0)
    hung = make_env(FLEET, noise=0.0, seed=0, device="cpu",
                    dispatch_factors=(float("inf"), 1, 1, 1))
    assert faults.nominal_duration(hung) == base
    # The dispatcher passes the round to the two-parameter duration.
    disp = slow.open_dispatch()
    assert disp._dur_wants_round and disp.fault_hook is None


# ---------------------------------------------------------------------------
# The fleet under chaos: the grid policy against the reference
# ---------------------------------------------------------------------------

def _grid_chaos(pkg_make_env, pkg_make_space, pkg_controller, pkg_policy,
                pkg_faults, pkg_obs, spec, device_kw):
    env = pkg_make_env(FLEET, noise=0.03, seed=0, **device_kw)
    space = pkg_make_space(FLEET)
    cm, _, opt_cost = serve._landscape_reference(env, space, 0.5)
    run_env = pkg_faults.wrap_env(
        pkg_make_env(FLEET, noise=0.03, seed=0, **device_kw),
        pkg_faults.parse_faults(spec))
    with pkg_obs.observing(None) as sess:
        res = pkg_controller.AsyncController(
            space, pkg_policy, cm, optimal_cost=opt_cost, seed=0,
            k=K).run(run_env, PULLS // K, pull_budget=PULLS)
    counters = {n: sess.metrics.counter(n).value for n in (
        "faults_injected_total", "retries_total", "pull_faults_total",
        "device_faults_total")}
    return res, counters


@pytest.mark.parametrize("spec", [CHAOS_SPEC, CENSORED_SPEC])
def test_grid_fleet_under_chaos_matches_the_reference(spec):
    res, counts = _grid_chaos(make_env, make_space, controller,
                              baselines.GridSearch(), faults, obs, spec,
                              {"device": "cpu"})
    ref, ref_counts = _grid_chaos(jax_make_env, jax_make_space,
                                  jax_controller, jax_baselines.GridSearch(),
                                  jax_faults, jax_obs, spec, {})
    assert counts == ref_counts and counts["faults_injected_total"] > 0
    assert len(res.records) + len(res.failed_pulls) == PULLS
    assert len(res.records) == len(ref.records)
    for r, j in zip(res.records, ref.records):
        assert (r.t, r.arm, r.round, r.slot) == (j.t, j.arm, j.round, j.slot)
        np.testing.assert_allclose(r.cost, j.cost, rtol=1e-6)
        for key in ("device", "submitted_at", "finished_at", "staleness"):
            assert r.obs.metadata[key] == j.obs.metadata[key], key
    assert [dataclasses.astuple(f) for f in res.failed_pulls] == \
        [dataclasses.astuple(f) for f in ref.failed_pulls]
    if spec == CENSORED_SPEC:
        assert res.failed_pulls
    assert res.best_arm == ref.best_arm


# ---------------------------------------------------------------------------
# E14's claims on the port, seed 0
# ---------------------------------------------------------------------------

def _e14_setup(seed, dispatch_factors=None):
    kw = dict(noise=0.03, seed=seed, device="cpu")
    if dispatch_factors is not None:
        kw["dispatch_factors"] = dispatch_factors
    env = make_env(FLEET, **kw)
    space = make_space(FLEET)
    cm = cost.CostModel(alpha=0.5)
    e_ref, l_ref = env.expected(space.values(space.corner()))
    cm = cm.with_reference(e_ref, l_ref)
    _, opt_cost = controller.landscape_optimal(space, env.expected, cm)
    _, mu0, sig0 = priors.jetson_camel_policy("llama3.2-1b", space)
    return kw, env, space, cm, opt_cost, mu0, sig0


def _e14_run(setup, seed, plan=None):
    kw, _, space, cm, opt_cost, mu0, sig0 = setup
    env = make_env(FLEET, **kw)
    if plan is not None:
        env = faults.wrap_env(env, plan)
    pol = baselines.make_policy("camel", prior_mu=mu0, prior_sigma=sig0)
    return controller.AsyncController(
        space, pol, cm, optimal_cost=opt_cost, seed=seed, k=K).run(
        env, PULLS // K, pull_budget=PULLS)


def _stream(res):
    return [(r.t, r.arm, r.cost, r.energy, r.latency,
             r.obs.metadata["device"], r.obs.metadata["staleness"],
             r.obs.metadata["finished_at"]) for r in res.records]


def test_e14_zero_and_idle_plans_are_noops():
    setup = _e14_setup(0)
    armed = faults.parse_faults("deadline=1e9,retries=3")
    assert not armed.is_zero
    bare = _stream(_e14_run(setup, 0))
    assert _stream(_e14_run(setup, 0, faults.FaultPlan())) == bare
    assert _stream(_e14_run(setup, 0, armed)) == bare
    assert len(bare) == PULLS


def test_e14_chaos_converges_on_the_exact_budget():
    setup = _e14_setup(0)
    _, env, space, cm = setup[:4]

    def commit_cost(arm):
        return float(cm.cost(*env.expected(space.values(arm))))

    c_clean = commit_cost(_e14_run(setup, 0).best_arm)
    for spec, want_failed in ((CHAOS_SPEC, False), (CENSORED_SPEC, True)):
        with obs.observing(None) as sess:
            chaos = _e14_run(setup, 0, faults.parse_faults(spec))
        assert sess.metrics.counter("faults_injected_total").value > 0
        assert len(chaos.records) + len(chaos.failed_pulls) == PULLS
        if want_failed:
            assert chaos.failed_pulls
        assert commit_cost(chaos.best_arm) / c_clean - 1.0 <= TOL, spec


def test_e14_hung_device_times_out_and_is_quarantined():
    setup = _e14_setup(0, dispatch_factors=(float("inf"), 1.0, 1.0, 1.0))
    sink = io.StringIO()
    with obs.observing(sink):
        res = _e14_run(setup, 0, faults.parse_faults("deadline=4,retries=3"))
    rows = [json.loads(line) for line in sink.getvalue().splitlines()]
    timeouts = [r for r in rows if r["name"] == "fault.pull"
                and r["attrs"].get("reason") == "timeout"]
    quarantines = [r for r in rows if r["name"] == "fault.device"]
    assert len(res.records) + len(res.failed_pulls) == PULLS
    assert timeouts and all(t["attrs"]["worker"] == 0 for t in timeouts)
    assert quarantines and quarantines[0]["attrs"]["worker"] == 0
    assert 0 not in {r.obs.metadata["device"] for r in res.records}


@pytest.mark.parametrize("scheduler", ["static", "continuous"])
def test_e14_engine_zero_plan_is_a_noop(scheduler):
    """`EngineEnvironment` handed the zero plan, or a sensor-only plan
    whose faults the meter absorbs, against no plan: the same requests
    and token streams, and with the zero plan the same observation."""
    kw = dict(seed=0, prompt_len=8, max_new_tokens=4, sensor="simulated",
              scheduler=scheduler, requests_per_pull=4, max_batch=4,
              max_seq_len=64, device="cpu")
    envs = [make_env("engine/smollm-360m", faults=p, **kw)
            for p in (None, faults.FaultPlan())]
    assert envs[1].faults is None
    knobs = {"freq_mhz": 930.75, "batch": 2}
    if scheduler == "continuous":
        streams = []
        for env in envs:
            reqs = env._continuous_workload(0)
            assert all(r.deadline_s is None for r in reqs)
            out, st = env.engine.generate_continuous(reqs, n_slots=4,
                                                     step_time_s=1.0)
            assert st.n_cancelled == 0
            streams.append([(r.rid, r.prompt.tolist(), r.arrival_s,
                             out[r.rid].tolist()) for r in reqs])
        assert streams[0] == streams[1]
    else:
        a, b = (env.pull(knobs, 0) for env in envs)
        assert a.tokens == b.tokens and a.power == b.power
    flaky = make_env("engine/smollm-360m", faults=faults.parse_faults(
        "sensor_drop=0.3,seed=1"), **kw)
    assert isinstance(flaky.sensor, faults.FlakySensor)


# ---------------------------------------------------------------------------
# Request cancellation against the JAX engine
# ---------------------------------------------------------------------------

#: (prompt length, budget, arrival) of the cancellation workload: two
#: seeds, then arrivals that refill freed slots; at cancel 0.5 after 4
#: step units, seed 1 cancels both seeds while they decode (their slots
#: refilled) and abandons one request still queued.
CANCEL_WORKLOAD = ((5, 14, 0.0), (9, 12, 0.0), (7, 10, 1.0), (4, 9, 2.0),
                   (6, 8, 3.0), (8, 6, 9.0))
CANCEL_SPEC = "cancel=0.5@4.0,seed=1"
N_SLOTS, CHUNK = 2, 2


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-3b"])
def test_cancellation_matches_the_jax_engine(arch):
    jcfg = dataclasses.replace(jax_configs.get_smoke(arch),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(torch_configs.get_smoke(arch),
                               dtype=torch.float32)
    jb, tb = jax_bundle_for(jcfg), bundle_for(tcfg)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    tparams = tb.module.params_from_jax(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).astype(np.int32)
               for n, _, _ in CANCEL_WORKLOAD]

    def requests(cls, pkg):
        reqs = [cls(rid=i, prompt=p, max_new_tokens=m, arrival_s=a)
                for i, (p, (_, m, a)) in enumerate(zip(prompts,
                                                       CANCEL_WORKLOAD))]
        return pkg.apply_request_faults(reqs, pkg.parse_faults(CANCEL_SPEC))

    kw = dict(n_slots=N_SLOTS, chunk=CHUNK, step_time_s=1.0)
    reqs = requests(EngineRequest, faults)
    out, st = InferenceEngine(tb, tparams, max_batch=4, max_seq_len=64,
                              prompt_bucket=8, device="cpu") \
        .generate_continuous(reqs, **kw)
    ref_out, ref_st = JaxEngine(jb, jparams, max_batch=4, max_seq_len=64,
                                prompt_bucket=8).generate_continuous(
        requests(JaxRequest, jax_faults), **kw)

    assert out.keys() == ref_out.keys()
    for rid in ref_out:
        np.testing.assert_array_equal(out[rid], ref_out[rid], err_msg=rid)
    fields = ("rid", "slot", "admit_s", "finish_s", "n_tokens", "cancelled",
              "tokens")
    assert [tuple(getattr(r, f) for f in fields) for r in st.records] == \
        [tuple(getattr(r, f) for f in fields) for r in ref_st.records]
    assert (st.n_cancelled, st.decode_steps, st.prefill_calls) == \
        (ref_st.n_cancelled, ref_st.decode_steps, ref_st.prefill_calls)
    # The plan bit: live requests were cancelled and their slots refilled,
    # and a cancelled request stops no later than the next chunk boundary
    # after its deadline (deadlines are checked between chunks; one
    # iteration is at most N_SLOTS admission prefills and CHUNK steps).
    deadline = {r.rid: r.deadline_s for r in reqs}
    cancelled = [r for r in st.records if r.cancelled and r.slot >= 0]
    assert len(cancelled) == 2 and st.n_cancelled == 3
    for r in cancelled:
        assert deadline[r.rid] <= r.finish_s < \
            deadline[r.rid] + N_SLOTS + CHUNK, r
        assert any(o.slot == r.slot and o.admit_s >= r.finish_s
                   for o in st.records), f"slot of {r.rid} never refilled"


# ---------------------------------------------------------------------------
# serve.py --faults
# ---------------------------------------------------------------------------

def test_serve_faults_prints_the_reference_keys(monkeypatch, capsys):
    runs = [(["--mode", "async-fleet", "--straggler", "4", "--faults",
              CHAOS_SPEC],
             jax_serve.async_fleet_mode(
                 "llama3.2-1b", 49, 0.5, 0, 4, straggler=4.0,
                 faults=jax_faults.parse_faults(CHAOS_SPEC))),
            (["--mode", "fleet", "--faults", "crash=1@2,throttle=2@0x2"],
             jax_serve.fleet_mode(
                 "llama3.2-1b", 49, 0.5, 0, 4,
                 faults=jax_faults.parse_faults(
                     "crash=1@2,throttle=2@0x2"))),
            (["--mode", "engine", "--rounds", "1", "--scheduler",
              "continuous", "--faults", "cancel=0.3@2,sensor_drop=0.2"],
             None),
            (["--mode", "fleet", "--faults", "none"], None)]
    for argv, ref in runs:
        monkeypatch.setattr("sys.argv", ["serve", "--device", "cpu", *argv])
        serve.main()
        out = json.loads(capsys.readouterr().out)
        spec = argv[argv.index("--faults") + 1]
        if spec == "none":
            assert "faults" not in out
            continue
        assert out.pop("faults") == spec
        if ref is not None:
            assert set(out) == set(ref), argv
        else:
            assert out["total_tokens"] > 0
