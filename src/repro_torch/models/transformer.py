"""Decoder-only transformer LM of the port: the all-global, dense path of
`repro.models.transformer` (the llama family).

Public API (used by serving/ and the tests):
    init_params(cfg, seed, device)       -> params
    params_from_jax(cfg, tree, device)   -> params from JAX's params tree
    forward(cfg, params, tokens)         -> (logits, aux)
    init_cache(cfg, batch, max_len, device) -> cache
    prefill(cfg, params, tokens, cache)  -> (last logits, cache)
    decode_step(cfg, params, token, cache, pos) -> (logits, cache)

Params keep the reference's key names and `[in, out]` weight layout.
The reference stacks layer params on a leading `[layers, ...]` axis for
`lax.scan`; here `params["layers"]` is a list of per-layer dicts (the loop
over layers is a Python loop).  The cache keeps the reference's stacked
`{"global": {"k", "v"}}` group, `[L, B, S, KVH, D]`, and each layer writes
its slice in place.

Mixed local/global layer patterns, MoE FFNs, qk-norm, biases, softcaps and
prefix embeddings are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import common, flash
from repro_torch.models.common import AttnSpec

Params = Dict[str, Any]
Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    norm: str = "rmsnorm"
    mlp_kind: str = "gated"
    act: str = "silu"
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True
    query_scale: Optional[float] = None
    attn_impl: str = "naive"       # "naive" | "flash"
    dtype: Any = torch.bfloat16
    max_seq_len: int = 131072

    def __post_init__(self):
        if (self.norm, self.mlp_kind, self.tie_embeddings) != \
                ("rmsnorm", "gated", True):
            raise ValueError(
                "the port has the rmsnorm / gated-MLP / tied-embedding "
                "path only")
        if self.attn_impl not in ("naive", "flash"):
            raise ValueError(f"attn_impl must be 'naive' or 'flash', got "
                             f"{self.attn_impl!r}")

    def attn_spec(self) -> AttnSpec:
        return AttnSpec(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            query_scale=self.query_scale, rope_theta=self.rope_theta,
            use_rope=self.use_rope, attn_impl=self.attn_impl)

    @property
    def n_params(self) -> int:
        """Total parameter count as the reference counts it (the tied
        embedding once, the final norm not)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kvh, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kvh * hd + h * hd * d
        per_layer = attn + 3 * d * f + 2 * d
        return self.n_layers * per_layer + v * d


# ---------------------------------------------------------------------------
# Init and weights from JAX
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> Params:
    """Random weights from a torch generator seeded with `seed`, made on
    `device` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec = cfg.attn_spec()
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({
            "norm_attn": common.rmsnorm_init(cfg.d_model, cfg.dtype, dev),
            "norm_mlp": common.rmsnorm_init(cfg.d_model, cfg.dtype, dev),
            "attn": common.attn_init(gen, spec, cfg.dtype, dev),
            "mlp": common.gated_mlp_init(gen, cfg.d_model, cfg.d_ff,
                                         cfg.dtype, dev),
        })
    return {"embedding": common.embed_init(gen, cfg.vocab_size, cfg.d_model,
                                           cfg.dtype, dev),
            "layers": layers,
            "final_norm": common.rmsnorm_init(cfg.d_model, cfg.dtype, dev)}


def _to_torch(a, dtype, device) -> Tensor:
    # np.asarray of a bf16 JAX array is an ml_dtypes.bfloat16 array, which
    # torch.from_numpy rejects; float32 holds every bf16 value exactly.
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()) \
        .to(device=device, dtype=dtype)


def params_from_jax(cfg: TransformerConfig, tree: Params,
                    device=None) -> Params:
    """The port's params from the JAX params tree of the same config
    (nested dicts of numpy or JAX arrays).  Keys are kept; the leading
    `[layers, ...]` axis of `tree["layers"]` is unstacked into a list of
    per-layer dicts; weights keep their `[in, out]` layout (no transpose).
    """
    dev = resolve_device(device)

    def conv(node, layer=None):
        if isinstance(node, dict):
            return {k: conv(v, layer) for k, v in node.items()}
        a = np.asarray(node, dtype=np.float32)
        return _to_torch(a if layer is None else a[layer], cfg.dtype, dev)

    n = np.asarray(tree["layers"]["norm_attn"]["scale"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.n_layers}")
    return {"embedding": conv(tree["embedding"]),
            "layers": [conv(tree["layers"], i) for i in range(n)],
            "final_norm": conv(tree["final_norm"])}


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------

def _mlp_block(cfg: TransformerConfig, lp: Params, x: Tensor) -> Tensor:
    h = common.rmsnorm(lp["norm_mlp"], x)
    return x + common.gated_mlp(lp["mlp"], h, cfg.act)


def forward(cfg: TransformerConfig, params: Params, tokens: Tensor
            ) -> Tuple[Tensor, Tensor]:
    """tokens: [B, S] int.  Returns (logits [B, S, V] fp32, aux loss 0).
    Attention is the naive masked softmax, or with `attn_impl == "flash"`
    the blocked reference of `models/flash.py`, as in the reference."""
    x = common.embed(params, tokens)
    b, s, _ = x.shape
    spec = cfg.attn_spec()
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    mask = common.causal_mask(s, s, device=x.device).expand(b, s, s)
    for lp in params["layers"]:
        h = common.rmsnorm(lp["norm_attn"], x)
        q, k, v = common._project_qkv(lp["attn"], spec, h, positions)
        if spec.attn_impl == "flash":
            ctx = flash.flash_attention(q, k, v, spec, causal=True)
        else:
            ctx = common.mha_attend(q, k, v, mask, spec)
        x = x + common.attn_out(lp["attn"], spec, ctx)
        x = _mlp_block(cfg, lp, x)
    x = common.rmsnorm(params["final_norm"], x)
    logits = common.unembed(params, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# KV-cache inference
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> Params:
    """The reference's all-global cache group, stacked over layers."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"global": {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}}


def _layer_cache(cache: Params, i: int) -> Params:
    g = cache["global"]
    return {"k": g["k"][i], "v": g["v"][i]}


def prefill(cfg: TransformerConfig, params: Params, tokens: Tensor,
            cache: Params, attn_mask: Optional[Tensor] = None,
            pos_offset: Optional[int] = None) -> Tuple[Tensor, Params]:
    """Run the prompt through the model, filling the cache in place.
    `attn_mask` ([B, S] bool, True = real token) masks left-padded slots
    out of every layer's keys.  `pos_offset` shifts the prompt to global
    positions [pos_offset, pos_offset + S) in RoPE and the cache writes.
    Returns (logits for the last position [B, V], cache)."""
    spec = cfg.attn_spec()
    x = common.embed(params, tokens)
    for i, lp in enumerate(params["layers"]):
        h = common.rmsnorm(lp["norm_attn"], x)
        a, _ = common.prefill_into_cache(lp["attn"], spec, h,
                                         _layer_cache(cache, i),
                                         pad_mask=attn_mask,
                                         pos_offset=pos_offset)
        x = _mlp_block(cfg, lp, x + a)
    x = common.rmsnorm(params["final_norm"], x[:, -1:])
    logits = common.unembed(params, x)
    return logits[:, 0], cache


def decode_step(cfg: TransformerConfig, params: Params, token: Tensor,
                cache: Params, pos: int,
                attn_mask: Optional[Tensor] = None) -> Tuple[Tensor, Params]:
    """token: [B] int; pos: global position of `token`.  `attn_mask`
    ([B, P] bool over global positions, True = real token) keeps
    left-padded prompt slots masked; positions >= P are always valid.
    Returns (logits [B, V], cache)."""
    spec = cfg.attn_spec()
    x = common.embed(params, token[:, None])
    for i, lp in enumerate(params["layers"]):
        h = common.rmsnorm(lp["norm_attn"], x)
        a, _ = common.cached_attention(lp["attn"], spec, h,
                                       _layer_cache(cache, i), pos,
                                       pad_mask=attn_mask)
        x = _mlp_block(cfg, lp, x + a)
    x = common.rmsnorm(params["final_norm"], x)
    logits = common.unembed(params, x)
    return logits[:, 0], cache
