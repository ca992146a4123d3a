"""Uniform model API of the port (the transformer family of
`repro.models.registry`).

A `ModelBundle` exposes the family-agnostic surface the serving engine
and tests consume:

    bundle.init_params(seed, device)
    bundle.forward(params, tokens)        -> (logits, aux)
    bundle.init_cache(batch, max_len, device)
    bundle.prefill(params, tokens, cache) -> (logits, cache)
    bundle.decode_step(params, token, cache, pos) -> (logits, cache)
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: Any
    family: str            # "transformer"
    module: Any

    def init_params(self, seed: int = 0, device=None):
        return self.module.init_params(self.cfg, seed, device)

    def forward(self, params, inputs, **kw):
        return self.module.forward(self.cfg, params, inputs, **kw)

    def init_cache(self, batch, max_len, device=None):
        return self.module.init_cache(self.cfg, batch, max_len, device)

    def prefill(self, params, inputs, cache, **kw):
        return self.module.prefill(self.cfg, params, inputs, cache, **kw)

    def decode_step(self, params, token, cache, pos, **kw):
        return self.module.decode_step(self.cfg, params, token, cache, pos,
                                       **kw)

    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def n_params(self) -> int:
        return self.cfg.n_params


_FAMILY_MODULES = {"transformer": transformer}

_FAMILY_OF_CONFIG = {transformer.TransformerConfig: "transformer"}


def bundle_for(cfg) -> ModelBundle:
    family = _FAMILY_OF_CONFIG[type(cfg)]
    return ModelBundle(cfg=cfg, family=family,
                       module=_FAMILY_MODULES[family])
