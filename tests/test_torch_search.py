"""The port's search loop against the JAX package's, on the CPU: the rest of
`core/bandit.py` (streaming, censored, windowed and contextual updates),
the baselines of `core/baselines.py`, the analytic prior of
`core/priors.py` and the asynchronous controller and convergence measures
of `core/controller.py`.

Deterministic updates are held to the reference at fp32 rtol 1e-6 (and
the port's own batch and chained forms to each other exactly); the
deterministic policies (grid, UCB1) give the reference's records in
`search_mode`; the random ones draw from another stream (a
`torch.Generator` against `jax.random`) and are matched by distribution:
3 sigma of a binomial at 4000 draws is < 0.024, held at 0.03."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bandit as jax_bandit
from repro.core import baselines as jax_baselines
from repro.core import controller as jax_controller
from repro.core.cost import CostModel as JaxCostModel
from repro.launch import serve as jax_serve
from repro.platform import make_env as jax_make_env
from repro.platform import make_space as jax_make_space
from repro_torch.core import arms, bandit, baselines, controller, priors
from repro_torch.launch import serve
from repro_torch.platform import make_env, make_space

LEAVES = ("mu", "sigma2", "prior_mu", "prior_sigma2", "count", "sum_x",
          "sum_x2", "stale_n")
CTX_LEAVES = ("arm_mean", "dev_resid_sum", "dev_resid_count", "dev_offset")
RTOL = 1e-6
DRAWS = 4000


def _close(t, j, err_msg=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=RTOL,
                               atol=RTOL, err_msg=err_msg)


def _ts_close(t, j):
    for name in LEAVES:
        _close(getattr(t, name).numpy(), getattr(j, name), name)


def _ctx_close(t, j):
    _ts_close(t.base, j.base)
    for name in CTX_LEAVES:
        _close(getattr(t, name).numpy(), getattr(j, name), name)


def _equal(a, b):
    """Two port states, leaf for leaf, bit for bit."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _equal(x, y)
        else:
            assert torch.equal(x, y), f.name


def _stream(n, n_arms=49, seed=0, n_dev=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_arms, n),
            rng.gamma(4.0, 0.25, n).astype(np.float32),
            rng.integers(-1, n_dev + 1, n))     # out-of-range ids included


# ---------------------------------------------------------------------------
# Deterministic updates
# ---------------------------------------------------------------------------

def test_streaming_and_censored_updates_match_jax():
    arms_seq, costs, _ = _stream(40, seed=1)
    prior = np.linspace(0.6, 1.4, 49).astype(np.float32)
    t = bandit.init_state(49, torch.from_numpy(prior), 0.2)
    j = jax_bandit.init_state(49, jnp.asarray(prior), 0.2)
    for i, (a, c) in enumerate(zip(arms_seq, costs)):
        if i % 5 == 4:
            t = bandit.update_censored(t, int(a), float(i % 3))
            j = jax_bandit.update_censored(j, int(a), float(i % 3))
        else:
            t = bandit.update_streaming(t, int(a), float(c))
            j = jax_bandit.update_streaming(j, int(a), float(c))
        _ts_close(t, j)
    # A censored pull never moves the empirical history.
    c = bandit.update_censored(t, 7)
    for name in ("count", "sum_x", "sum_x2"):
        assert torch.equal(getattr(c, name), getattr(t, name))


@pytest.mark.parametrize("seed", [0, 6346, 11])
def test_update_batch_equals_the_chained_updates(seed):
    """`update_batch` over K distinct arms is the K chained `update`s bit
    for bit, and the reference's batch at rtol 1e-6.  Unlike the
    reference's property (tests/test_batch_controller.py) this does not
    also claim that posterior stds never grow: a new observation can
    raise an arm's estimated observation noise and so its posterior std
    (the reference's own example seed=6346, k=7, n_arms=11 raises one
    arm's sigma2 by 0.0456)."""
    rng = np.random.default_rng(seed)
    n_arms, k = 11, 7
    state = bandit.init_state(n_arms, 1.0, 0.3)
    jstate = jax_bandit.init_state(n_arms, 1.0, 0.3)
    for r in range(4):
        arms_r = rng.permutation(n_arms)[:k]
        costs_r = rng.gamma(3.0, 0.3, k).astype(np.float32)
        chained = state
        for a, c in zip(arms_r, costs_r):
            chained = bandit.update(chained, int(a), float(c))
        state = bandit.update_batch(state, arms_r, costs_r)
        _equal(state, chained)
        jstate = jax_bandit.update_batch(jstate, jnp.asarray(arms_r),
                                         jnp.asarray(costs_r))
        _ts_close(state, jstate)


def test_windowed_updates_match_jax():
    arms_seq, costs, _ = _stream(60, seed=2)
    t = bandit.init_windowed(49, 0.9, 1.0, 0.5)
    j = jax_bandit.init_windowed(49, 0.9, 1.0, 0.5)
    for a, c in zip(arms_seq[:30], costs[:30]):
        t = bandit.windowed_update(t, int(a), float(c))
        j = jax_bandit.windowed_update(j, int(a), float(c))
    _ts_close(t.base, j.base)
    arms_b, costs_b = arms_seq[30:], costs[30:]
    tb = bandit.windowed_update_batch(t, arms_b, costs_b)
    chained = t
    for a, c in zip(arms_b, costs_b):
        chained = bandit.windowed_update(chained, int(a), float(c))
    _equal(tb, chained)
    jb = jax_bandit.windowed_update_batch(j, jnp.asarray(arms_b),
                                          jnp.asarray(costs_b))
    _ts_close(tb.base, jb.base)


def test_contextual_updates_match_jax():
    """The fresh, stale and batched device-aware updates (out-of-range
    device ids included) against the reference, leaf for leaf."""
    arms_seq, costs, devs = _stream(48, seed=3)
    t = bandit.init_contextual(49, 4, 1.0, 0.3)
    j = jax_bandit.init_contextual(49, 4, 1.0, 0.3)
    for i in range(24):
        a, c, d = int(arms_seq[i]), float(costs[i]), int(devs[i])
        if i % 2:
            t = bandit.contextual_update_stale(t, a, c, d, float(i % 3))
            j = jax_bandit.contextual_update_stale(j, a, c, d, float(i % 3))
        else:
            t = bandit.contextual_update(t, a, c, d)
            j = jax_bandit.contextual_update(j, a, c, d)
        _ctx_close(t, j)
    assert float(t.dev_resid_count.sum()) > 0     # the offsets learned
    for r in range(3):
        sl = slice(24 + 8 * r, 32 + 8 * r)
        t = bandit.contextual_update_batch(t, arms_seq[sl], costs[sl],
                                           devs[sl])
        j = jax_bandit.contextual_update_batch(
            j, jnp.asarray(arms_seq[sl]), jnp.asarray(costs[sl]),
            jnp.asarray(devs[sl]))
        _ctx_close(t, j)
    t = bandit.contextual_update_batch(t, [3, 9], [0.8, 1.1])   # shared
    j = jax_bandit.contextual_update_batch(j, jnp.asarray([3, 9]),
                                           jnp.asarray([0.8, 1.1]))
    _ctx_close(t, j)


def test_contextual_with_one_device_is_camel():
    """With one device every offset is exactly 0, so the contextual
    policy's shared posterior and its selections are CamelTS's bit for
    bit, on the fresh, stale and batched paths."""
    arms_seq, costs, _ = _stream(30, seed=4)
    ctx = baselines.make_policy("contextual", n_devices=1, prior_mu=1.0,
                                prior_sigma=0.2)
    camel = baselines.make_policy("camel", prior_mu=1.0, prior_sigma=0.2)
    cs, ts = ctx.init(49), camel.init(49)
    for i in range(10):
        a, c = int(arms_seq[i]), float(costs[i])
        cs = ctx.update(cs, a, c, device=0)
        ts = camel.update(ts, a, c)
        cs = ctx.update_stale(cs, a, c, 2.0, device=0)
        ts = camel.update_stale(ts, a, c, 2.0)
    for r in range(2):
        arms_r = np.random.default_rng(r).permutation(49)[:10]
        costs_r = costs[10 * r:10 * r + 10]
        cs = ctx.update_batch(cs, arms_r, costs_r, devices=[0] * 10)
        ts = camel.update_batch(ts, arms_r, costs_r)
    _equal(cs.base, ts)
    assert float(cs.dev_offset.abs().max()) == 0.0
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert [ctx.select(cs, g1, 1) for _ in range(20)] == \
        [camel.select(ts, g2, 1) for _ in range(20)]
    assert torch.equal(ctx.select_many(cs, g1, 1, 6),
                       camel.select_many(ts, g2, 1, 6))


def test_run_bandit_finds_the_cheap_arm():
    costs = torch.linspace(1.0, 2.0, 8)
    costs[5] = 0.5
    state, pulled, observed = bandit.run_bandit(
        torch.Generator().manual_seed(0), costs, 60, prior_sigma=0.5,
        cost_noise=0.05)
    assert pulled.shape == (60,) and observed.shape == (60,)
    assert int(torch.bincount(pulled.long(), minlength=8).argmax()) == 5
    assert int(state.count.sum()) == 60


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

def _jax_counts(select, draws=DRAWS, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), draws)
    return np.asarray(jax.vmap(select)(keys))


def _pulled_states(n_arms=12, seed=6):
    """A CountState / UCBState pair with every arm pulled."""
    rng = np.random.default_rng(seed)
    count = rng.integers(1, 5, n_arms).astype(np.int32)
    sum_x = (count * rng.uniform(0.5, 1.5, n_arms)).astype(np.float32)
    return (baselines.UCBState(count=torch.from_numpy(count),
                               sum_x=torch.from_numpy(sum_x)),
            jax_baselines.UCBState(count=jnp.asarray(count),
                                   sum_x=jnp.asarray(sum_x)))


@pytest.mark.parametrize("name", ["eps_greedy", "random", "camel_windowed"])
def test_random_policies_match_jax_in_distribution(name):
    kwargs = {"eps_greedy": {"eps": 0.3}}.get(name, {})
    tp = baselines.make_policy(name, **kwargs)
    jp = jax_baselines.make_policy(name, **kwargs)
    if name == "camel_windowed":
        n = 6
        mu = np.array([1.0, 0.95, 1.05, 0.9, 1.2, 0.97], np.float32)
        sd = np.array([0.1, 0.05, 0.2, 0.15, 0.3, 0.02], np.float32)
        ts = bandit.init_windowed(n, 0.95, torch.from_numpy(mu),
                                  torch.from_numpy(sd))
        js = jax_bandit.init_windowed(n, 0.95, jnp.asarray(mu),
                                      jnp.asarray(sd))
    else:
        ts, js = _pulled_states()
        n = ts.count.shape[0]
    gen = torch.Generator().manual_seed(0)
    t_arms = [tp.select(ts, gen, 1) for _ in range(DRAWS)]
    j_arms = _jax_counts(lambda k: jp.select(js, k, jnp.asarray(1)))
    np.testing.assert_allclose(np.bincount(t_arms, minlength=n) / DRAWS,
                               np.bincount(j_arms, minlength=n) / DRAWS,
                               atol=0.03)


def test_deterministic_policies_select_as_jax():
    """Grid and UCB1 have no randomness: the same state and round give the
    same arm, before and after the sweep (UCB1 over a range of t)."""
    ts, js = _pulled_states()
    ucb, jucb = baselines.UCB1(), jax_baselines.UCB1()
    for t in (1, 2, 7, 30, 200):
        assert ucb.select(ts, None, t) == \
            int(jucb.select(js, None, jnp.asarray(t)))
    grid, jgrid = baselines.GridSearch(), jax_baselines.GridSearch()
    g, jg = grid.init(5), jgrid.init(5)
    for i, c in enumerate([1.2, 0.7, 0.9, 0.7, 1.5]):
        assert grid.select(g, None, i) == int(jgrid.select(jg, None, i))
        assert grid.select_many(g, None, i, 3).tolist() == \
            np.asarray(jgrid.select_many(jg, None, i, 3)).tolist()
        g, jg = grid.update(g, i, c), jgrid.update(jg, i, c)
    assert grid.select(g, None, 5) == int(jgrid.select(jg, None, 5)) == 1
    assert controller.commit_arm(g) == jax_controller.commit_arm(jg)


def _records_of(pkg_make_env, pkg_make_space, pkg_controller, pkg_policy,
                model, k, device_kw):
    name = f"jetson/{model}/landscape"
    env = pkg_make_env(name, noise=0.03, seed=0, **device_kw)
    space = pkg_make_space(name)
    cm, opt_arm, opt_cost = serve._landscape_reference(env, space, 0.5)
    res = pkg_controller.BatchController(
        space, pkg_policy, cm, optimal_cost=opt_cost, seed=0, k=k).run(
        env, -(-49 // k), pull_budget=49)
    return res


@pytest.mark.parametrize("policy", ["grid", "ucb1"])
@pytest.mark.parametrize("k", [1, 4])
def test_deterministic_search_matches_reference(policy, k):
    """`search_mode` under grid and UCB1: the reference's arms record by
    record, costs within 1e-6, and the summary's values within 1e-6
    (the batched pulls evaluate in fp32 in both packages)."""
    model = "llama3.2-1b" if k == 1 else "qwen2.5-3b"
    res = _records_of(make_env, make_space, controller,
                      baselines.make_policy(policy), model, k,
                      {"device": "cpu"})
    jres = _records_of(jax_make_env, jax_make_space, jax_controller,
                       jax_baselines.make_policy(policy), model, k, {})
    assert [r.arm for r in res.records] == [r.arm for r in jres.records]
    _close([r.cost for r in res.records], [r.cost for r in jres.records])
    out = serve.search_mode(model, 49, 0.5, 0, policy_name=policy, k=k,
                            device="cpu")
    ref = jax_serve.search_mode(model, 49, 0.5, 0, policy_name=policy, k=k)
    assert set(out) == set(ref)
    for key, val in ref.items():
        if isinstance(val, float):
            np.testing.assert_allclose(out[key], val, rtol=RTOL, err_msg=key)
        else:
            assert out[key] == val, key


def test_camel_search_finds_the_papers_optimum():
    """Camel with the analytic prior on both Orin workloads commits to the
    calibrated optimum, as the reference's search does (its own stream)."""
    for model, knobs in (("llama3.2-1b", {"freq_mhz": 816.0, "batch": 20}),
                         ("qwen2.5-3b", {"freq_mhz": 930.75, "batch": 24})):
        out = serve.search_mode(model, 49, 0.5, 0, device="cpu")
        assert out["optimal_knobs"] == knobs and out["found_optimal"], model


# ---------------------------------------------------------------------------
# Priors
# ---------------------------------------------------------------------------

def test_jetson_policies_carry_the_analytic_prior():
    space = arms.paper_arm_space()
    policy, mu0, sig0 = priors.jetson_camel_policy("qwen2.5-3b", space, 0.3)
    assert isinstance(policy, baselines.CamelTS)
    state = policy.init(49)
    np.testing.assert_array_equal(state.prior_mu.numpy(), mu0)
    ctx, cmu, csig = priors.jetson_contextual_policy("qwen2.5-3b", space, 4,
                                                     0.3)
    assert isinstance(ctx, bandit.ContextualTS) and ctx.n_devices == 4
    np.testing.assert_array_equal(cmu, mu0)
    np.testing.assert_array_equal(csig, sig0)
    flat_mu, flat_sig = priors.flat_prior(space)
    assert flat_mu.shape == flat_sig.shape == (49,)


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------

def test_accepts_kw_reads_the_widened_signatures():
    ctx = bandit.ContextualTS(2)
    camel = baselines.CamelTS()
    assert controller._accepts_kw(ctx.update, "device")
    assert controller._accepts_kw(ctx.update_batch, "devices")
    assert not controller._accepts_kw(camel.update, "device")
    assert controller._accepts_kw(lambda s, **kw: s, "device")
    assert not controller._accepts_kw(None, "device")
    for fn, name in ((ctx.update_stale, "device"),
                     (camel.update_batch, "devices")):
        assert controller._accepts_kw(fn, name) == \
            jax_controller._accepts_kw(fn, name)


def test_convergence_measures_match_jax():
    """The commit history and the convergence measures over one set of
    records (ties included), in both packages."""
    rng = np.random.default_rng(7)
    n_arms = 9
    recs, jrecs = [], []
    for t in range(40):
        a = int(rng.integers(0, n_arms))
        c = float(np.round(rng.uniform(0.5, 1.5) - 0.4 * (a == 4), 1))
        kw = dict(t=t, arm=a, knobs={}, energy=1.0, latency=1.0, cost=c,
                  regret=0.0, round=t // 3, slot=t % 3)
        recs.append(controller.RoundRecord(**kw))
        jrecs.append(jax_controller.RoundRecord(**kw))
    prior = np.linspace(1.2, 0.8, n_arms)
    clocks = np.cumsum(rng.uniform(0.5, 2.0, 40))
    assert controller.committed_best_history(recs, prior, n_arms) == \
        jax_controller.committed_best_history(jrecs, prior, n_arms)
    for opt in range(n_arms):
        args = (opt, prior, n_arms)
        assert controller.rounds_to_converge(recs, *args) == \
            jax_controller.rounds_to_converge(jrecs, *args)
        assert controller.pulls_to_converge(recs, *args) == \
            jax_controller.pulls_to_converge(jrecs, *args)
        assert controller.walltime_to_converge(recs, clocks, *args) == \
            jax_controller.walltime_to_converge(jrecs, clocks, *args)


def test_landscape_optimal_matches_jax():
    for model in ("llama3.2-1b", "qwen2.5-3b"):
        name = f"jetson/{model}/landscape"
        env, jenv = make_env(name, device="cpu"), jax_make_env(name)
        space, jspace = make_space(name), jax_make_space(name)
        cm, opt_arm, opt_cost = serve._landscape_reference(env, space, 0.3)
        jcm = JaxCostModel(alpha=0.3).with_reference(
            *jenv.expected(jspace.values(jspace.corner())))
        assert (opt_arm, opt_cost) == jax_controller.landscape_optimal(
            jspace, jenv.expected, jcm)
