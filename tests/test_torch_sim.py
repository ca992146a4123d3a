"""The port's simulators, dispatcher, fleet, registry and serve modes
against the JAX package's, on the CPU.

The closed-form landscape's `expected` and sequential `pull` are f64 numpy
in both packages and equal; its batched `pull_many` is an fp32 closed form
in both (XLA there, PyTorch here), held at 1e-6 relative; the event-driven
server is numpy in both and `validate_mode` agrees to 1e-9.  The fleet
modes under grid search (no random stream) give the reference's records,
dispatcher clocks and staleness.  Every figure here is the modelled
Jetson AGX Orin."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import platform as jax_platform
from repro.core import baselines as jax_baselines
from repro.core import controller as jax_controller
from repro.core.cost import CostModel as JaxCostModel
from repro.launch import serve as jax_serve
from repro.serving import energy as jax_energy
from repro.serving import simulator as jax_sim
from repro.serving.requests import ArrivalProcess as JaxArrivals
from repro_torch import platform
from repro_torch.core import baselines, controller
from repro_torch.core.cost import CostModel
from repro_torch.launch import serve
from repro_torch.serving import energy, simulator
from repro_torch.serving.requests import ArrivalProcess

MODELS = ("llama3.2-1b", "qwen2.5-3b")
RTOL = 1e-6


def _obs_close(t, j, rtol):
    for f in ("energy", "latency", "batch_time", "queue_wait", "backlog",
              "power"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=rtol,
                                   atol=0 if rtol == 0 else 1e-12,
                                   err_msg=f)
    assert (t.batch, t.tokens) == (j.batch, j.tokens)


def _arms(space, n=20, seed=0):
    idx = np.random.default_rng(seed).integers(0, space.n_arms, n)
    return [space.values(int(a)) for a in idx]


# ---------------------------------------------------------------------------
# The landscape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS)
def test_landscape_env_matches_reference(model):
    """expected and pull equal the reference's f64 values exactly (the
    same seeded noise); pull_many is within 1e-6 and advances the same
    noise stream."""
    name = f"jetson/{model}/landscape"
    env = platform.make_env(name, seed=3, device="cpu")
    jenv = jax_platform.make_env(name, seed=3)
    space = platform.make_space(name)
    knobs = _arms(space)
    for k in knobs[:5]:
        _obs_close(env.expected(k), jenv.expected(k), 0)
        _obs_close(env.pull(k, 0), jenv.pull(k, 0), 0)
    for o, jo in zip(env.pull_many(knobs, 5), jenv.pull_many(knobs, 5)):
        _obs_close(o, jo, RTOL)
        assert o.metadata == jo.metadata
    assert env.platform.current_level == jenv.platform.current_level
    # The noise stream stayed in step: the next scalar pull is equal.
    _obs_close(env.pull(knobs[0], 9), jenv.pull(knobs[0], 9), 0)


def test_energy_landscape_matches_reference():
    for model in MODELS:
        args = ([4, 8, 20, 28], 1.3, 600, 1.2)
        e, l = energy.landscape(energy.JETSON_AGX_ORIN,
                                energy.ORIN_WORKLOADS[model], *args)
        je, jl = jax_energy.landscape(jax_energy.JETSON_AGX_ORIN,
                                      jax_energy.ORIN_WORKLOADS[model],
                                      *args)
        np.testing.assert_array_equal(e, je)
        np.testing.assert_array_equal(l, jl)


# ---------------------------------------------------------------------------
# The event-driven server
# ---------------------------------------------------------------------------

def _close_tree(out, ref, rtol):
    assert set(out) == set(ref)
    for key, val in ref.items():
        if isinstance(val, dict):
            _close_tree(out[key], val, rtol)
        elif isinstance(val, float):
            np.testing.assert_allclose(out[key], val, rtol=rtol,
                                       err_msg=key)
        else:
            assert out[key] == val, key


@pytest.mark.parametrize("model", MODELS)
def test_validate_mode_matches_reference(model):
    out = serve.validate_mode(model, 300, 0.5, 0, device="cpu")
    ref = jax_serve.validate_mode(model, 300, 0.5, 0)
    _close_tree(out, ref, 1e-9)
    assert out["maxf_maxb"]["edp_vs_maxf_maxb"] == 0.0


def test_event_environment_matches_reference():
    name = "jetson/qwen2.5-3b/events"
    env = platform.make_env(name, requests_per_pull=60, seed=2)
    jenv = jax_platform.make_env(name, requests_per_pull=60, seed=2)
    space = platform.make_space(name)
    for i, k in enumerate(_arms(space, 4)):
        o, jo = env.pull(k, i), jenv.pull(k, i)
        _obs_close(o, jo, 1e-12)
        assert o.metadata == jo.metadata
    assert platform.measurement_horizon(env) == 60.0 == \
        jax_platform.measurement_horizon(jenv)


def test_online_tuner_matches_reference_in_distribution():
    """`OnlineCamelTuner`: `observe` updates the posterior as the
    reference's does, and its selections from that posterior match the
    reference's by distribution (other random stream)."""
    space = platform.make_space("jetson/llama3.2-1b/landscape")
    cm = CostModel(0.5).with_reference(10.0, 10.0)
    jcm = JaxCostModel(0.5).with_reference(10.0, 10.0)
    pol = baselines.make_policy("camel", prior_mu=1.0, prior_sigma=0.05)
    jpol = jax_baselines.make_policy("camel", prior_mu=1.0,
                                     prior_sigma=0.05)
    tuner = simulator.OnlineCamelTuner(space, pol, cm, seed=0)
    jtuner = jax_sim.OnlineCamelTuner(space, jpol, jcm, seed=0)
    rng = np.random.default_rng(4)
    for arm in rng.integers(0, 49, 30):
        tuner._last_arm = jtuner._last_arm = int(arm)
        e, lat = rng.uniform(6, 14, 2)
        tuner.observe(e, lat)
        jtuner.observe(e, lat)
    np.testing.assert_allclose(tuner.state.mu.numpy(),
                               np.asarray(jtuner.state.mu), rtol=RTOL)
    draws = 4000
    counts = np.bincount([space.index(**tuner(0, None))
                          for _ in range(draws)], minlength=49)
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    jarms = jax.vmap(lambda k: jpol.select(jtuner.state, k,
                                           jnp.asarray(1)))(keys)
    np.testing.assert_allclose(counts / draws,
                               np.bincount(np.asarray(jarms),
                                           minlength=49) / draws, atol=0.03)


def test_event_driven_server_closes_the_loop():
    """A tuner with `observe` gets each batch's measured stats; the run
    serves every request once."""
    board, work = energy.JETSON_AGX_ORIN, energy.ORIN_WORKLOADS["llama3.2-1b"]
    space = platform.make_space("jetson/llama3.2-1b/landscape")
    tuner = simulator.OnlineCamelTuner(
        space, baselines.make_policy("camel", prior_sigma=0.1),
        CostModel(0.5).with_reference(10.0, 10.0), seed=1)
    res = simulator.EventDrivenServer(
        board, work, ArrivalProcess(interval_s=1.0, seed=0), 200).run(tuner)
    assert sum(b.size for b in res.batches) == 200 == len(
        res.request_latencies)
    assert len(tuner._observations) == len(res.batches)
    jres = jax_sim.EventDrivenServer(
        jax_energy.JETSON_AGX_ORIN, jax_energy.ORIN_WORKLOADS["llama3.2-1b"],
        JaxArrivals(interval_s=1.0, seed=0), 200).run(
        jax_sim.fixed_config_tuner(816.0, 20))
    fixed = simulator.EventDrivenServer(
        board, work, ArrivalProcess(interval_s=1.0, seed=0), 200).run(
        simulator.fixed_config_tuner(816.0, 20))
    _close_tree(fixed.summary(), jres.summary(), 1e-12)


# ---------------------------------------------------------------------------
# Dispatcher, fleet, registry
# ---------------------------------------------------------------------------

def _fleet_records(pkg_platform, pkg_controller, pkg_policy, straggler,
                   device_kw):
    name = "fleet/4xjetson/llama3.2-1b/landscape"
    kw = dict(noise=0.03, seed=0, **device_kw)
    if straggler is not None:
        kw["dispatch_factors"] = (straggler, 1.0, 1.0, 1.0)
    env = pkg_platform.make_env(name, **kw)
    space = pkg_platform.make_space(name)
    cm, opt_arm, opt_cost = serve._landscape_reference(env, space, 0.5)
    cls = pkg_controller.BatchController if straggler is None \
        else pkg_controller.AsyncController
    return cls(space, pkg_policy, cm, optimal_cost=opt_cost, seed=0,
               k=4).run(env, 13, pull_budget=49)


@pytest.mark.parametrize("straggler", [None, 4.0])
def test_fleet_grid_search_matches_reference(straggler):
    """`fleet_mode` (straggler None) and `async_fleet_mode` under grid
    search: the reference's arms, serving devices, costs, dispatcher
    clocks and staleness record by record, and its summary."""
    res = _fleet_records(platform, controller, baselines.GridSearch(),
                         straggler, {"device": "cpu"})
    jres = _fleet_records(jax_platform, jax_controller,
                          jax_baselines.GridSearch(), straggler, {})
    assert len(res.records) == len(jres.records) == 49
    for r, j in zip(res.records, jres.records):
        assert (r.t, r.arm, r.round, r.slot) == (j.t, j.arm, j.round, j.slot)
        np.testing.assert_allclose(r.cost, j.cost, rtol=RTOL)
        for key in ("device", "submitted_at", "finished_at", "staleness"):
            assert r.obs.metadata.get(key) == j.obs.metadata.get(key), key
    if straggler is None:
        out = serve.fleet_mode("llama3.2-1b", 49, 0.5, 0, 4,
                               policy_name="grid", device="cpu")
        ref = jax_serve.fleet_mode("llama3.2-1b", 49, 0.5, 0, 4,
                                   policy_name="grid")
    else:
        out = serve.async_fleet_mode("llama3.2-1b", 49, 0.5, 0, 4,
                                     straggler=straggler, policy_name="grid",
                                     device="cpu")
        ref = jax_serve.async_fleet_mode("llama3.2-1b", 49, 0.5, 0, 4,
                                         straggler=straggler,
                                         policy_name="grid")
        assert out["mean_staleness"] > 0
    _close_tree(out, ref, RTOL)


@pytest.mark.parametrize("policy", ["camel", "contextual"])
def test_async_equals_batch_on_a_homogeneous_fleet(policy):
    """Equal dispatch factors and K = devices: every wave is a full round,
    every staleness 0, and the async loop's records are the batch loop's
    (same generator draws, same device rotation, same arithmetic)."""
    space = platform.make_space("jetson/llama3.2-1b/landscape")
    pol = serve._fleet_policy(policy, "llama3.2-1b", space, 0.5, 4)
    sync = _fleet_records(platform, controller, pol, None, {"device": "cpu"})
    asyn = _fleet_records(platform, controller, pol, 1.0, {"device": "cpu"})
    for r, a in zip(sync.records, asyn.records, strict=True):
        assert (r.t, r.arm, r.round, r.slot, r.cost) == \
            (a.t, a.arm, a.round, a.slot, a.cost)
        assert r.obs.metadata["device"] == a.obs.metadata["device"]
        assert a.obs.metadata["staleness"] == 0
    assert sync.best_arm == asyn.best_arm


class _CrashingFleet:
    """Two workers; worker 0 crashes on every pull."""

    n_devices = 2

    def pull_on(self, d, knobs, logical_round):
        if d == 0:
            raise self.fault("crash", d)
        return (1.0 + logical_round, 2.0)

    def pull_duration(self, d):
        return 1.0


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_dispatcher_retries_and_quarantines_a_crashing_worker(pkg):
    base = platform.base if pkg == "port" else jax_platform.base
    env = _CrashingFleet()
    env.fault = base.PullFault
    disp = base.AsyncDispatcher(env)
    tickets = [disp.submit({"arm": i}, i) for i in range(3)]
    waves = []
    while disp.in_flight:
        waves.append([(c.ticket, c.worker, c.finished_at, c.attempts,
                       c.fault) for c in disp.pop_wave()])
    assert tickets == [0, 1, 2]
    assert disp.quarantined == {0} and disp.retries == 1
    assert [(f.ticket, f.worker, f.reason) for f in disp.failed] == \
        [(0, 0, "crash")]
    assert waves == [[(0, 1, 2.0, 2, None)], [(1, 1, 3.0, 1, None)],
                     [(2, 1, 4.0, 1, None)]]


class _HungFleet:
    """Three workers; worker 1 never returns (an infinite duration)."""

    n_devices = 3

    def pull_on(self, d, knobs, logical_round):
        return (1.0 + d, 2.0)

    def pull_duration(self, d):
        return float("inf") if d == 1 else 1.5


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_dispatcher_deadline_and_fault_hook(pkg):
    """A hung worker times out at the deadline and is quarantined, and a
    fault hook's injected failures are retried elsewhere; the completions
    (worker, clock, attempts, fault) are the same in both packages."""
    base = platform.base if pkg == "port" else jax_platform.base
    hook = lambda ticket, worker, attempt, rnd: \
        "flaky" if (ticket, attempt) == (3, 1) else None
    disp = base.AsyncDispatcher(_HungFleet(), deadline_s=2.0,
                                fault_hook=hook, max_attempts=2)
    for i in range(5):
        disp.submit({"arm": i}, i)
    done = []
    while disp.in_flight:
        done.extend((c.ticket, c.worker, c.finished_at, c.attempts, c.fault)
                    for c in disp.pop_wave())
    assert disp.quarantined == {1}
    assert [(f.ticket, f.worker, f.reason) for f in disp.failed] == \
        [(1, 1, "timeout"), (3, 2, "flaky")]
    # Ticket 1 times out on worker 1 at 2.0 and reruns on worker 0 (free
    # at 1.5) from 2.0; ticket 3's injected failure on worker 2 ends at
    # 3.0, where it reruns.
    assert sorted(done) == [(0, 0, 1.5, 1, None), (1, 0, 3.5, 2, None),
                            (2, 2, 1.5, 1, None), (3, 2, 4.5, 2, None),
                            (4, 0, 5.0, 1, None)]


def test_fleet_helpers_match_reference():
    name = "fleet/3xjetson/qwen2.5-3b/landscape"
    env = platform.make_env(name, seed=1, dispatch_factors=(1.0, 3.0, 1.0),
                            device="cpu")
    jenv = jax_platform.make_env(name, seed=1,
                                 dispatch_factors=(1.0, 3.0, 1.0))
    assert env.speed_factors == jenv.speed_factors
    assert env.power_factors == jenv.power_factors
    np.testing.assert_array_equal(
        platform.barrier_walltimes(env, 5, 2, pull_budget=9),
        jax_platform.barrier_walltimes(jenv, 5, 2, pull_budget=9))
    knobs = _arms(platform.make_space(name), 5)
    _obs_close(env.expected(knobs[0]), jenv.expected(knobs[0]), 1e-15)
    merged = platform.merge_observations(env.pull_many(knobs, 10))
    jmerged = jax_platform.merge_observations(jenv.pull_many(knobs, 10))
    _obs_close(merged, jmerged, RTOL)
    assert merged.metadata == jmerged.metadata
    comps = platform.pull_async(env, knobs, 3)
    jcomps = jax_platform.pull_async(jenv, knobs, 3)
    assert [(c.ticket, c.worker, c.finished_at) for c in comps] == \
        [(c.ticket, c.worker, c.finished_at) for c in jcomps]


def test_registry_resolves_the_reference_names():
    for name, cls in (("jetson/llama3.2-1b/landscape",
                       simulator.LandscapeEnv),
                      ("jetson/qwen2.5-3b/events",
                       simulator.EventEnvironment),
                      ("fleet/4xjetson/llama3.2-1b/landscape",
                       platform.FleetEnv)):
        env = platform.make_env(name, device="cpu") \
            if "events" not in name else platform.make_env(name)
        assert isinstance(env, cls), name
        assert platform.parse_name(name) == jax_platform.parse_name(name)
        assert platform.make_space(name).knobs == \
            jax_platform.make_space(name).knobs
    assert set(platform.available_envs()) <= set(
        jax_platform.available_envs())
    assert "jetson/qwen2.5-3b/events" in platform.available_envs()
    for bad in ("fleet/4jetson/llama3.2-1b/landscape",
                "jetson/llama3.2-1b/nope", "jetson/gpt-9/landscape"):
        with pytest.raises(KeyError):
            platform.make_env(bad)
    assert isinstance(platform.as_platform(energy.JETSON_AGX_ORIN),
                      platform.DVFSPlatform)


# ---------------------------------------------------------------------------
# serve.py
# ---------------------------------------------------------------------------

def test_serve_modes_print_the_reference_keys(monkeypatch, capsys):
    """`python -m repro_torch.launch.serve --device cpu` with no other flag
    runs search (the reference's default), and the validate, contextual
    fleet and straggler async-fleet modes print the reference's keys."""
    runs = [([], jax_serve.search_mode("llama3.2-1b", 49, 0.5, 0)),
            (["--mode", "validate", "--requests", "300"],
             jax_serve.validate_mode("llama3.2-1b", 300, 0.5, 0)),
            (["--mode", "fleet", "--policy", "contextual"],
             jax_serve.fleet_mode("llama3.2-1b", 49, 0.5, 0, 4,
                                  policy_name="contextual")),
            (["--mode", "async-fleet", "--straggler", "4"],
             jax_serve.async_fleet_mode("llama3.2-1b", 49, 0.5, 0, 4,
                                        straggler=4.0))]
    for argv, ref in runs:
        monkeypatch.setattr("sys.argv", ["serve", "--device", "cpu", *argv])
        serve.main()
        out = json.loads(capsys.readouterr().out)
        assert set(out) == set(ref), argv
        if "validate" in argv:
            for cname, val in ref.items():
                assert set(out[cname]) == set(val), cname
    assert out["wall_clock_sim_s"] > 0


def test_device_reaches_the_landscape():
    env = platform.make_env("fleet/2xjetson/llama3.2-1b/landscape",
                            device="cpu")
    assert all(d.device == torch.device("cpu") for d in env.devices)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            platform.make_env("jetson/llama3.2-1b/landscape")
