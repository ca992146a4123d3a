"""repro_torch.platform — the contract between the Camel controller and
the engine backend: `Platform` / `DVFSPlatform` (base.py), `Observation`
and the queueing model (telemetry.py), and the `make_env` / `make_space`
/ `pull_many` registry (registry.py)."""

from repro_torch.platform.base import (BaseEnvironment, DVFSPlatform,
                                       FailedPull, Platform)
from repro_torch.platform.registry import (available_envs, make_env,
                                           make_space, parse_name,
                                           pull_many, register_env)
from repro_torch.platform.telemetry import (Observation, QueueingLatency,
                                            observe, queue_wait,
                                            queueing_latency,
                                            saturation_backlog)

__all__ = [
    "BaseEnvironment", "DVFSPlatform", "FailedPull", "Platform",
    "available_envs", "make_env", "make_space", "parse_name", "pull_many",
    "register_env", "Observation", "QueueingLatency", "observe",
    "queue_wait", "queueing_latency", "saturation_backlog",
]
