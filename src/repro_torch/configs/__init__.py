"""Architecture configs of the port: every config of `repro.configs`.

`get(name)` returns the full config; `get_smoke(name)` the reduced
same-family config for CPU tests and the default engine environment;
`input_specs(name, shape)` the dry run's inputs (`specs.py`).  `ARCHS`
lists the ten assigned architectures, `EDGE_MODELS` the paper's two edge
models, by module name as the reference lists them."""

from __future__ import annotations

import importlib
from typing import Dict, List

ARCHS: List[str] = [
    "rwkv6_3b",
    "phi3_vision_4p2b",
    "smollm_360m",
    "qwen2_1p5b",
    "gemma2_27b",
    "starcoder2_7b",
    "seamless_m4t_large_v2",
    "mixtral_8x22b",
    "olmoe_1b_7b",
    "recurrentgemma_9b",
]

EDGE_MODELS: List[str] = ["llama32_1b", "qwen25_3b"]

ALIASES: Dict[str, str] = {
    "llama3.2-1b": "llama32_1b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "rwkv6-3b": "rwkv6_3b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen2-1.5b": "qwen2_1p5b",
    "qwen2.5-3b": "qwen25_3b",
    "smollm-360m": "smollm_360m",
    "starcoder2-7b": "starcoder2_7b",
    "gemma2-27b": "gemma2_27b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "mixtral-8x22b": "mixtral_8x22b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
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


def input_specs(name: str, shape: str):
    """Meta-tensor stand-ins for the dry run; see each config module."""
    return _module(name).input_specs(shape)
