"""Environment registry of the port: construct a Camel backend by name.

Names follow ``<platform>/<model>/<scenario>``; this slice has one
backend, the real PyTorch engine:

    engine/llama3.2-1b            real InferenceEngine (scenario "live"
                                  implied; "engine/<arch>/live" also ok)

`make_env` returns the environment, `make_space` the matching ArmSpace,
`pull_many` evaluates a batch of knob dicts (slot i is logical round
``round_index + i``).  New backends register with
``register_env(platform, scenario)``.  The Jetson/TPU simulators and
fleets of `repro.platform.registry` are not ported yet.
"""

from __future__ import annotations

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
                       f"'<platform>/<model>/<scenario>', got {name!r}")
    return platform, model, scenario


def _check_model(platform: str, model: str) -> None:
    fn = _MODELS.get(platform)
    if fn is not None and model not in fn():
        raise KeyError(f"unknown {platform} model {model!r}; "
                       f"available: {sorted(fn())}")


def make_env(name: str, **overrides):
    """Construct the environment `name` with constructor overrides."""
    platform, model, scenario = parse_name(name)
    try:
        builder = _BUILDERS[(platform, scenario)]
    except KeyError:
        raise KeyError(f"no environment {platform!r}/{scenario!r}; "
                       f"available: {available_envs()}") from None
    _check_model(platform, model)
    return builder(model, **overrides)


def make_space(name: str, **overrides):
    """The ArmSpace matching environment `name`."""
    platform, _, scenario = parse_name(name)
    try:
        builder = _SPACES[(platform, scenario)]
    except KeyError:
        raise KeyError(f"no arm space for {platform!r}/{scenario!r}; "
                       f"available: {available_envs()}") from None
    return builder(**overrides)


def available_envs() -> Tuple[str, ...]:
    names = []
    for (p, s) in _BUILDERS:
        fn = _MODELS.get(p)
        for m in (sorted(fn()) if fn is not None else ["<model>"]):
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


# ---------------------------------------------------------------------------
# Built-in backend (imports deferred so `import repro_torch.platform` stays
# light; the model and engine load only when the backend is built)
# ---------------------------------------------------------------------------


def _config_archs() -> List[str]:
    import repro_torch.configs as configs_mod
    return sorted(set(configs_mod.ALIASES) | set(configs_mod.ALIASES
                                                 .values()))


@register_env("engine", "live", space=paper_arm_space,
              models=_config_archs)
def _engine_live(arch: str, *, seed: int = 0, max_batch: int = 28,
                 max_seq_len: int = 128, prompt_len: int = 16,
                 max_new_tokens: int = 8, arrival_rate: float = 1.0,
                 decode_impl: str = "fused", prompt_bucket: int = 16,
                 device=None):
    """The engine backend on `arch`'s smoke config with seeded random
    weights, as the reference builds it; runs on CUDA unless `device`
    says otherwise."""
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
                             max_new_tokens=max_new_tokens, seed=seed)
