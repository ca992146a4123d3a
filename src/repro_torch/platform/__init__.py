"""repro_torch.platform — the contract between the Camel controller and
every backend of the port:

* `Platform` / `DVFSPlatform` (base.py): one hardware abstraction (levels,
  power, set_level);
* `Observation` and the queueing model (telemetry.py);
* `make_env` / `make_space` / `pull_many` (registry.py): construct a
  backend by name, e.g. ``make_env("jetson/llama3.2-1b/landscape")``;
* `AsyncDispatcher` / `Completion` (base.py) with `open_dispatcher` /
  `pull_async` (registry.py): the asynchronous completion-queue path;
* `FleetEnv` / `make_fleet` (fleet.py): N devices behind one shared
  arrival queue.
"""

from repro_torch.platform.base import (AsyncDispatcher, BaseEnvironment,
                                       Completion, DVFSPlatform, FailedPull,
                                       Platform, PullFault, as_platform,
                                       measurement_horizon)
from repro_torch.platform.fleet import (FleetEnv, barrier_walltimes,
                                        make_fleet, merge_observations)
from repro_torch.platform.registry import (available_envs, make_env,
                                           make_space, open_dispatcher,
                                           parse_name, pull_async,
                                           pull_many, register_env)
from repro_torch.platform.telemetry import (Observation, QueueingLatency,
                                            observe, queue_wait,
                                            queueing_latency,
                                            saturation_backlog)

__all__ = [
    "AsyncDispatcher", "BaseEnvironment", "Completion", "DVFSPlatform",
    "FailedPull", "FleetEnv", "Platform", "PullFault", "as_platform",
    "available_envs", "barrier_walltimes", "make_env", "make_fleet",
    "make_space", "measurement_horizon", "merge_observations",
    "open_dispatcher", "parse_name", "pull_async", "pull_many",
    "register_env", "Observation", "QueueingLatency", "observe",
    "queue_wait", "queueing_latency", "saturation_backlog",
]
