"""The port's bandit, policy, controller and copied framework-free
modules against the JAX package's, the serve driver end to end on the
CPU, and the package's import hygiene."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import arms as jax_arms
from repro.core import bandit as jax_bandit
from repro.core import baselines as jax_baselines
from repro.core import controller as jax_controller
from repro.core import priors as jax_priors
from repro.core.cost import CostModel as JaxCostModel
from repro.platform.telemetry import observe as jax_observe
from repro.serving import energy as jax_energy
from repro_torch.core import arms, bandit, baselines, controller, priors
from repro_torch.core.cost import CostModel
from repro_torch.platform.telemetry import observe
from repro_torch.serving import energy

REPO = Path(__file__).resolve().parents[1]
LEAVES = ("mu", "sigma2", "prior_mu", "prior_sigma2", "count", "sum_x",
          "sum_x2", "stale_n")


def _assert_states_equal(t, j, tol=1e-6):
    for name in LEAVES:
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), rtol=tol,
                                   atol=tol, err_msg=name)


def _stream(n=40, n_arms=49, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_arms, n),
            rng.gamma(4.0, 0.25, n).astype(np.float32))


def test_update_sequence_matches_jax():
    arms_seq, costs = _stream()
    prior = np.linspace(0.5, 1.5, 49).astype(np.float32)
    t = bandit.init_state(49, torch.from_numpy(prior), 0.1)
    j = jax_bandit.init_state(49, jnp.asarray(prior), 0.1)
    for a, c in zip(arms_seq, costs):
        t = bandit.update(t, int(a), float(c))
        j = jax_bandit.update(j, int(a), float(c))
    _assert_states_equal(t, j)
    np.testing.assert_allclose(t.mean_cost().numpy(),
                               np.asarray(j.mean_cost()), rtol=1e-6)
    np.testing.assert_allclose(t.obs_std().numpy(), np.asarray(j.obs_std()),
                               rtol=1e-6)


def test_update_stale_matches_jax():
    arms_seq, costs = _stream(seed=1)
    t = bandit.init_state(49)
    j = jax_bandit.init_state(49)
    for i, (a, c) in enumerate(zip(arms_seq, costs)):
        t = bandit.update_stale(t, int(a), float(c), float(i % 3))
        j = jax_bandit.update_stale(j, int(a), float(c), float(i % 3))
    _assert_states_equal(t, j)
    s0 = bandit.update_stale(t, 3, 0.7, 0.0)
    u = bandit.update(t, 3, 0.7)
    for name in LEAVES:
        assert torch.equal(getattr(s0, name), getattr(u, name))


def test_update_batch_matches_sequential_and_jax():
    arms_seq, costs = _stream(n=12, seed=2)
    arms_seq = np.random.default_rng(2).permutation(49)[:12]  # distinct
    state = bandit.init_state(49)
    state = bandit.update(state, 5, 0.9)
    seq = state
    for a, c in zip(arms_seq, costs):
        seq = bandit.update(seq, int(a), float(c))
    batch = bandit.update_batch(state, arms_seq, costs)
    for name in LEAVES:
        assert torch.equal(getattr(batch, name), getattr(seq, name)), name
    j = jax_bandit.update(jax_bandit.init_state(49), 5, 0.9)
    j = jax_bandit.update_batch(j, jnp.asarray(arms_seq), jnp.asarray(costs))
    _assert_states_equal(batch, j)


def test_commit_arm_agrees_with_jax():
    arms_seq, costs = _stream(n=60, seed=3)
    t = bandit.init_state(49)
    j = jax_bandit.init_state(49)
    for a, c in zip(arms_seq, np.round(costs, 1)):   # exact ties happen
        t = bandit.update(t, int(a), float(c))
        j = jax_bandit.update(j, int(a), float(c))
    assert controller.commit_arm(t) == jax_controller.commit_arm(j)


def test_selection_matches_jax_in_distribution():
    """Both samplers draw from the same posterior but different random
    streams, so compare arm frequencies over many draws (3 sigma of a
    binomial at 4000 draws is < 0.024)."""
    n_arms, draws = 6, 4000
    mu = np.array([1.0, 0.95, 1.05, 0.9, 1.2, 0.97], np.float32)
    sd = np.array([0.1, 0.05, 0.2, 0.15, 0.3, 0.02], np.float32)
    t = bandit.init_state(n_arms, torch.from_numpy(mu),
                          torch.from_numpy(sd))
    j = jax_bandit.init_state(n_arms, jnp.asarray(mu), jnp.asarray(sd))
    gen = torch.Generator().manual_seed(0)
    t_counts = np.bincount([bandit.select_arm(t, gen) for _ in range(draws)],
                           minlength=n_arms)
    keys = jax.random.split(jax.random.PRNGKey(0), draws)
    j_arms = jax.vmap(lambda k: jax_bandit.select_arm(j, k))(keys)
    j_counts = np.bincount(np.asarray(j_arms), minlength=n_arms)
    np.testing.assert_allclose(t_counts / draws, j_counts / draws, atol=0.03)


def test_select_arms_without_replacement():
    state = bandit.init_state(49, 1.0, 0.001)
    picked = bandit.select_arms(state, torch.Generator().manual_seed(1), 10)
    assert picked.dtype == torch.int32 and len(set(picked.tolist())) == 10
    with pytest.raises(ValueError, match="k must be"):
        bandit.select_arms(state, torch.Generator(), 50)


class _Landscape:
    """A deterministic environment: cost grows with distance from one arm."""

    def __init__(self, space, obs_fn):
        self.space, self.obs_fn = space, obs_fn

    def pull(self, knobs, round_index):
        arm = self.space.index(**knobs)
        return self.obs_fn(power_w=10.0 + abs(arm - 20),
                           batch_time_s=0.5, batch=knobs["batch"],
                           arrival_rate=1.0, n_requests=knobs["batch"],
                           tokens=8)


def test_controller_runs_the_camel_loop():
    space = arms.paper_arm_space()
    policy = baselines.make_policy("camel", prior_mu=1.0, prior_sigma=0.1)
    cm = CostModel(alpha=0.5).with_reference(1.0, 1.0)
    res = controller.Controller(space, policy, cm, seed=0).run(
        _Landscape(space, observe), 30)
    assert len(res.records) == 30 and res.n_rounds == 30
    assert int(res.final_state.count.sum()) == 30
    s = res.summary()
    assert s["total_tokens"] == 240
    batch = controller.BatchController(space, policy, cm, seed=0, k=4).run(
        _Landscape(space, observe), 3, pull_budget=10)
    assert len(batch.records) == 10 and batch.n_rounds == 3
    with pytest.raises(KeyError, match="unknown policy"):
        baselines.make_policy("annealing")


def test_copied_modules_match_reference():
    assert arms.paper_arm_space().knobs == jax_arms.paper_arm_space().knobs
    space = arms.paper_arm_space()
    assert [space.values(a) for a in range(49)] == \
        [jax_arms.paper_arm_space().values(a) for a in range(49)]
    assert energy.JETSON_AGX_ORIN.__dict__ == \
        jax_energy.JETSON_AGX_ORIN.__dict__
    assert energy.ORIN_WORKLOADS["llama3.2-1b"].__dict__ == \
        jax_energy.ORIN_WORKLOADS["llama3.2-1b"].__dict__
    o = observe(20.0, 0.3, 8, 1.5, n_requests=8, tokens=64)
    jo = jax_observe(20.0, 0.3, 8, 1.5, n_requests=8, tokens=64)
    assert (o.energy, o.latency, o.queue_wait) == \
        (jo.energy, jo.latency, jo.queue_wait)
    cm, jcm = CostModel(0.3, 2.0, 3.0), JaxCostModel(0.3, 2.0, 3.0)
    assert cm.cost(1.5, 2.5) == jcm.cost(1.5, 2.5)
    # core/priors.py: the analytic prior of both Orin workloads.
    for model in ("llama3.2-1b", "qwen2.5-3b"):
        for alpha in (0.5, 0.3):
            _, mu0, sig0 = priors.jetson_camel_policy(model, space, alpha)
            _, jmu0, jsig0 = jax_priors.jetson_camel_policy(
                model, jax_arms.paper_arm_space(), alpha)
            np.testing.assert_array_equal(mu0, jmu0)
            np.testing.assert_array_equal(sig0, jsig0)


def test_serve_engine_mode_prints_the_reference_summary():
    """`serve.py --mode engine --device cpu --rounds 2` prints a JSON
    summary with the keys of the JAX controller's summary."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
         "engine", "--device", "cpu", "--rounds", "2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout)
    space = jax_arms.paper_arm_space()
    ref = jax_controller.Controller(
        space, jax_baselines.make_policy("camel"), JaxCostModel(),
        seed=0).run(_Landscape(space, jax_observe), 2).summary()
    assert set(out) == set(ref)
    assert out["total_tokens"] > 0 and out["energy_per_req"] > 0


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files.extend(sorted((REPO / "scripts").glob("*.py")))
    assert len(files) > 20
    names = {f.relative_to(REPO).as_posix() for f in files}
    for mod in ("core/priors.py", "platform/fleet.py",
                "serving/simulator.py", "launch/serve.py",
                "faults/plan.py", "faults/injectors.py",
                "models/encdec.py", "training/optimizer.py",
                "training/data.py", "training/checkpoint.py",
                "training/compression.py", "training/elastic.py",
                "training/tree.py", "launch/train.py", "launch/steps.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for f in files:
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "flax"), (f, mod)
