"""Environment registry of the port: construct a Camel backend by name.

Names follow ``<platform>/<model>/<scenario>``:

    jetson/llama3.2-1b/landscape  closed-form Jetson landscape + noise
                                  (the modelled Jetson AGX Orin)
    jetson/qwen2.5-3b/events      event-driven simulation per pull
    engine/llama3.2-1b            real InferenceEngine (scenario "live"
                                  implied; "engine/<arch>/live" also ok)

plus the composite fleet form ``fleet/<n>x<platform>/<model>/<scenario>``
(e.g. ``fleet/4xjetson/llama3.2-1b/landscape``): N devices of the named
backend behind one shared arrival queue (`repro_torch.platform.fleet`).

`make_env` returns the environment, `make_space` the matching ArmSpace,
`pull_many` evaluates a batch of knob dicts (slot i is logical round
``round_index + i``); `open_dispatcher` / `pull_async` are the
asynchronous counterparts through `platform.base.AsyncDispatcher`, whose
results return in finish order.  Constructors take keyword overrides
(noise=, seed=, arrival_rate=, device=, ...) that pass straight to the
environment's constructor.  New backends register with
``register_env(platform, scenario)``.  The reference's TPU backends are
not ported (ROADMAP.md).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.core.arms import paper_arm_space
from repro_torch.platform.telemetry import Observation

# (platform, scenario) -> builder(model, **overrides) -> Environment
_BUILDERS: Dict[Tuple[str, str], Callable] = {}

# (platform, scenario) -> space builder(**overrides) -> ArmSpace
_SPACES: Dict[Tuple[str, str], Callable] = {}

# platform -> callable() -> list of valid model names
_MODELS: Dict[str, Callable[[], Sequence[str]]] = {}

#: Platforms whose names may omit the scenario ("engine/<arch>").
_DEFAULT_SCENARIO = {"engine": "live"}

_FLEET_SPEC = re.compile(r"^(\d+)x(.+)$")


def register_env(platform: str, scenario: str, space: Callable = None,
                 models: Callable[[], Sequence[str]] = None):
    """Decorator registering an environment builder (and optionally the
    matching arm-space builder and a model-name lister)."""
    def deco(fn):
        _BUILDERS[(platform, scenario)] = fn
        if space is not None:
            _SPACES[(platform, scenario)] = space
        if models is not None:
            _MODELS[platform] = models
        return fn
    return deco


def parse_name(name: str) -> Tuple[str, str, str]:
    parts = name.split("/")
    if parts and parts[0] == "fleet":
        if len(parts) != 4 or not _FLEET_SPEC.match(parts[1]):
            raise KeyError(
                f"fleet environment name must be "
                f"'fleet/<n>x<platform>/<model>/<scenario>' "
                f"(e.g. 'fleet/4xjetson/llama3.2-1b/landscape'), got "
                f"{name!r}")
        return f"fleet/{parts[1]}", parts[2], parts[3]
    if len(parts) == 2:
        platform, model = parts
        scenario = _DEFAULT_SCENARIO.get(platform)
        if scenario is None:
            raise KeyError(
                f"environment name {name!r} omits the scenario and platform "
                f"{platform!r} has no default; use "
                "'<platform>/<model>/<scenario>'")
    elif len(parts) == 3:
        platform, model, scenario = parts
    else:
        raise KeyError(f"environment name must be "
                       f"'<platform>/<model>/<scenario>' or "
                       f"'fleet/<n>x<platform>/<model>/<scenario>', "
                       f"got {name!r}")
    return platform, model, scenario


def _fleet_spec(platform: str) -> Tuple[int, str]:
    """'fleet/<n>x<base>' -> (n, base)."""
    m = _FLEET_SPEC.match(platform[len("fleet/"):])
    return int(m.group(1)), m.group(2)


def _models_of(platform: str) -> List[str]:
    fn = _MODELS.get(platform)
    if fn is None:
        return ["<model>"]
    return sorted(fn())


def _check_model(platform: str, model: str) -> None:
    fn = _MODELS.get(platform)
    if fn is not None and model not in fn():
        raise KeyError(f"unknown {platform} model {model!r}; "
                       f"available: {sorted(fn())}")


def _builder(name: str) -> Tuple[Callable, str, Tuple[str, str]]:
    platform, model, scenario = parse_name(name)
    if platform.startswith("fleet/"):
        n, base = _fleet_spec(platform)
        if (base, scenario) not in _BUILDERS:
            raise KeyError(f"no environment {base!r}/{scenario!r} to build "
                           f"a fleet from; available: {available_envs()}")
        _check_model(base, model)

        def fleet_builder(model, **kw):
            from repro_torch.platform.fleet import make_fleet
            return make_fleet(n, base, model, scenario, **kw)

        return fleet_builder, model, (base, scenario)
    try:
        builder = _BUILDERS[(platform, scenario)]
    except KeyError:
        raise KeyError(f"no environment {platform!r}/{scenario!r}; "
                       f"available: {available_envs()}") from None
    _check_model(platform, model)
    return builder, model, (platform, scenario)


def make_env(name: str, **overrides):
    """Construct the environment `name` with constructor overrides."""
    builder, model, _ = _builder(name)
    return builder(model, **overrides)


def make_space(name: str, **overrides):
    """The ArmSpace matching environment `name` (fleet names use the base
    platform's space: all devices share one grid)."""
    platform, _, scenario = parse_name(name)
    if platform.startswith("fleet/"):
        _, platform = _fleet_spec(platform)
    try:
        builder = _SPACES[(platform, scenario)]
    except KeyError:
        raise KeyError(f"no arm space for {platform!r}/{scenario!r}; "
                       f"available: {available_envs()}") from None
    return builder(**overrides)


def available_envs() -> Tuple[str, ...]:
    """All constructible names (fleets compose on top of any of these:
    'fleet/<n>x' + name)."""
    names = []
    for (p, s) in _BUILDERS:
        for m in _models_of(p):
            names.append(f"{p}/{m}/{s}")
    return tuple(sorted(names))


def pull_many(env, knobs_list: Sequence[dict], round_index: int = 0
              ) -> List[Observation]:
    """Batched-evaluation hook: the environment's own `pull_many` when it
    has one, else sequential pulls; slot i is logical round
    ``round_index + i``.  Always returns Observations."""
    fn = getattr(env, "pull_many", None)
    if fn is not None:
        return [Observation.of(o) for o in fn(knobs_list, round_index)]
    return [Observation.of(env.pull(k, round_index + i))
            for i, k in enumerate(knobs_list)]


def open_dispatcher(env, n_workers: int = None):
    """Open the asynchronous completion-queue path onto `env`: the
    environment's own `open_dispatch()` hook when it defines one, else the
    simulated event-clock `AsyncDispatcher` with one worker per fleet
    device (one for a plain environment)."""
    from repro_torch.platform.base import AsyncDispatcher

    fn = getattr(env, "open_dispatch", None)
    if fn is not None:
        return fn() if n_workers is None else fn(n_workers=n_workers)
    return AsyncDispatcher(env, n_workers=n_workers)


def pull_async(env, knobs_list: Sequence[dict], round_index: int = 0,
               n_workers: int = None) -> List:
    """Asynchronous counterpart of `pull_many`: evaluate the batch through
    the completion queue and return `Completion`s in finish order (ties in
    submission order).  Slot i is still logical round
    ``round_index + i``: the delay path changes when an observation
    arrives, never what it observed."""
    disp = open_dispatcher(env, n_workers=n_workers)
    for i, knobs in enumerate(knobs_list):
        disp.submit(knobs, round_index + i)
    out = []
    while disp.in_flight:
        out.extend(disp.pop_wave())
    return out


# ---------------------------------------------------------------------------
# Built-in backends (imports deferred so `import repro_torch.platform` stays
# light; the simulators, model and engine load only when a backend is built)
# ---------------------------------------------------------------------------


def _jetson_models() -> List[str]:
    from repro_torch.serving import energy
    return list(energy.ORIN_WORKLOADS)


def _orin_workload(model: str):
    from repro_torch.serving import energy
    try:
        return energy.JETSON_AGX_ORIN, energy.ORIN_WORKLOADS[model]
    except KeyError:
        raise KeyError(f"unknown jetson model {model!r}; "
                       f"have {sorted(energy.ORIN_WORKLOADS)}") from None


@register_env("jetson", "landscape", space=paper_arm_space,
              models=_jetson_models)
def _jetson_landscape(model: str, **kw):
    """The modelled Orin landscape; `device=` is where its batched pulls
    evaluate (CUDA unless given)."""
    from repro_torch.serving import simulator
    board, work = _orin_workload(model)
    return simulator.LandscapeEnv(board, work, **kw)


@register_env("jetson", "events", space=paper_arm_space,
              models=_jetson_models)
def _jetson_events(model: str, **kw):
    from repro_torch.serving import simulator
    board, work = _orin_workload(model)
    return simulator.EventEnvironment(board, work, **kw)


def _config_archs() -> List[str]:
    import repro_torch.configs as configs_mod
    return sorted(set(configs_mod.ALIASES) | set(configs_mod.ALIASES
                                                 .values()))


@register_env("engine", "live", space=paper_arm_space,
              models=_config_archs)
def _engine_live(arch: str, *, seed: int = 0, max_batch: int = 28,
                 max_seq_len: int = 128, prompt_len: int = 16,
                 max_new_tokens: int = 8, arrival_rate: float = 1.0,
                 sensor=None, sample_hz: float = 20.0,
                 decode_impl: str = "fused", prompt_bucket: int = 16,
                 scheduler: str = "static",
                 requests_per_pull=None, eos_id=None, chunk: int = 16,
                 faults=None, device=None):
    """The engine backend on `arch`'s smoke config with seeded random
    weights, as the reference builds it; runs on CUDA unless `device`
    says otherwise.  `sensor`/`sample_hz` meter each pull,
    `scheduler`/`requests_per_pull`/`eos_id`/`chunk` pick the serving
    discipline and `faults` (a `FaultPlan`) injects sensor faults and
    request cancellations (`serving.engine.EngineEnvironment`)."""
    import repro_torch.configs as configs_mod
    from repro_torch._device import resolve_device
    from repro_torch.models.registry import bundle_for
    from repro_torch.serving import energy
    from repro_torch.serving.engine import EngineEnvironment, InferenceEngine
    dev = resolve_device(device)
    try:
        cfg = configs_mod.get_smoke(arch)
    except ModuleNotFoundError:
        raise KeyError(f"unknown engine model {arch!r}; "
                       f"available: {sorted(configs_mod.ALIASES)}") from None
    bundle = bundle_for(cfg)
    params = bundle.init_params(seed, dev)
    engine = InferenceEngine(bundle, params, max_batch=max_batch,
                             max_seq_len=max_seq_len,
                             decode_impl=decode_impl,
                             prompt_bucket=prompt_bucket, device=dev)
    board = energy.JETSON_AGX_ORIN
    work = energy.ORIN_WORKLOADS["llama3.2-1b"]
    return EngineEnvironment(engine, board, work,
                             arrival_rate=arrival_rate,
                             prompt_len=prompt_len,
                             max_new_tokens=max_new_tokens, seed=seed,
                             sensor=sensor, sample_hz=sample_hz,
                             scheduler=scheduler,
                             requests_per_pull=requests_per_pull,
                             eos_id=eos_id, chunk=chunk, faults=faults)
