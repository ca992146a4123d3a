"""Uniform model API of the port (`repro.models.registry`: the transformer,
rwkv6, rglru and encdec families).

A `ModelBundle` exposes the family-agnostic surface the serving engine
and tests consume:

    bundle.init_params(seed, device)      bundle.abstract_params()
    bundle.loss_fn(params, batch)         -> scalar loss
    bundle.forward(params, inputs)        -> (logits, aux)
    bundle.init_cache(batch, max_len, device)
    bundle.prefill(params, inputs, cache) -> (logits, cache)
    bundle.decode_step(params, token, cache, pos) -> (logits, cache)

`inputs` are tokens [B, S], or for the encdec family
{"speech_embeddings": [B, T, D], "tokens": [B, S]}, as in the reference.
Every family trains (`loss_fn`, `abstract_params`): its kernels carry
backward kernels of their own (RMSNorm, the grouped GEMM, WKV6, the gated
RG-LRU); the encoder-decoder launches none.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.models import encdec, rglru, rwkv6, transformer

@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: Any
    family: str            # "transformer" | "rwkv6" | "rglru" | "encdec"
    module: Any

    def init_params(self, seed: int = 0, device=None):
        return self.module.init_params(self.cfg, seed, device)

    def abstract_params(self):
        """The params tree on the meta device: every leaf's shape and
        dtype, no memory (the template a checkpoint is restored into)."""
        return self.module.init_params(self.cfg, 0, "meta")

    def loss_fn(self, params, batch):
        return self.module.loss_fn(self.cfg, params, batch)

    def forward(self, params, inputs, **kw):
        return self.module.forward(self.cfg, params, inputs, **kw)

    def init_cache(self, batch, max_len, device=None):
        return self.module.init_cache(self.cfg, batch, max_len, device)

    def prefill(self, params, inputs, cache, **kw):
        return self.module.prefill(self.cfg, params, inputs, cache, **kw)

    def decode_step(self, params, token, cache, pos, **kw):
        return self.module.decode_step(self.cfg, params, token, cache, pos,
                                       **kw)

    def zero_state(self, cache) -> None:
        """Zero the recurrent part of a reused cache in place: the state
        prefill starts from and updates (rwkv6: all of it; rglru: `lru_h`
        and `conv_tail`; the transformer and encdec: nothing, since stale KV
        entries are masked or rewritten)."""
        for key in self.module.STATE_KEYS:
            cache[key].zero_()

    @property
    def name(self) -> str:
        return self.cfg.name

    @property
    def n_params(self) -> int:
        return self.cfg.n_params

    @property
    def n_active_params(self) -> int:
        return self.cfg.n_active_params


_FAMILY_MODULES = {"transformer": transformer, "rwkv6": rwkv6,
                   "rglru": rglru, "encdec": encdec}

_FAMILY_OF_CONFIG = {transformer.TransformerConfig: "transformer",
                     rwkv6.RWKV6Config: "rwkv6",
                     rglru.RGLRUConfig: "rglru",
                     encdec.EncDecConfig: "encdec"}


def bundle_for(cfg) -> ModelBundle:
    family = _FAMILY_OF_CONFIG[type(cfg)]
    return ModelBundle(cfg=cfg, family=family,
                       module=_FAMILY_MODULES[family])
