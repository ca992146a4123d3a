"""Architecture configs of the port (llama3.2-1b, olmoe-1b-7b, rwkv6-3b and
recurrentgemma-9b of `repro.configs`).

`get(name)` returns the full config; `get_smoke(name)` the reduced
same-family config for CPU tests and the default engine environment."""

from __future__ import annotations

import importlib
from typing import Dict

ALIASES: Dict[str, str] = {
    "llama3.2-1b": "llama32_1b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "rwkv6-3b": "rwkv6_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in ALIASES.values():
        raise ModuleNotFoundError(f"no port config {name!r}; have "
                                  f"{sorted(ALIASES)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(name: str):
    """Full (published-width) config."""
    return _module(name).config()


def get_smoke(name: str):
    """Reduced same-family config for CPU tests."""
    return _module(name).smoke_config()
