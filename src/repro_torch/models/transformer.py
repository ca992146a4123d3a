"""Decoder-only transformer LM of the port: the all-global path of
`repro.models.transformer`, with dense (llama) or MoE (olmoe) FFNs,
optional qk-norm and tied or untied embeddings.

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

Mixed local/global layer patterns, sliding windows, biases, softcaps,
layernorm, dense (non-gated) MLPs, embedding scaling, post-norms, int8 KV
caches and prefix embeddings are not ported yet (ROADMAP.md, Queue 1):
`TransformerConfig` keeps the reference's fields for them and refuses any
value but the default.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models import common, flash
from repro_torch.models.common import AttnSpec
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init

Params = Dict[str, Any]
Tensor = torch.Tensor


#: Reference fields whose paths are not ported, with the one value the port
#: takes (the reference's default).
_UNPORTED = {"norm": "rmsnorm", "mlp_kind": "gated", "use_bias": False,
             "qkv_bias": False, "attn_softcap": 0.0, "final_softcap": 0.0,
             "embed_scale": False, "post_norms": False, "sliding_window": 0,
             "layer_pattern": ("global",), "kv_cache_dtype": "native",
             "num_prefix_embeddings": 0}


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
    use_bias: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    query_scale: Optional[float] = None
    qk_norm: bool = False          # olmoe
    embed_scale: bool = False
    post_norms: bool = False
    sliding_window: int = 0
    layer_pattern: Tuple[str, ...] = ("global",)
    attn_impl: str = "naive"       # "naive" | "flash"
    kv_cache_dtype: str = "native"
    moe: Optional[MoEConfig] = None
    num_prefix_embeddings: int = 0
    dtype: Any = torch.bfloat16
    max_seq_len: int = 131072

    def __post_init__(self):
        for field, value in _UNPORTED.items():
            if getattr(self, field) != value:
                raise ValueError(
                    f"the port has no {field}={getattr(self, field)!r} path "
                    f"yet (only {value!r}); see ROADMAP.md Queue 1")
        if self.attn_impl not in ("naive", "flash"):
            raise ValueError(f"attn_impl must be 'naive' or 'flash', got "
                             f"{self.attn_impl!r}")

    def attn_spec(self) -> AttnSpec:
        return AttnSpec(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            query_scale=self.query_scale, rope_theta=self.rope_theta,
            use_rope=self.use_rope, qk_norm=self.qk_norm,
            attn_impl=self.attn_impl)

    def _count(self, experts_per_token: Optional[int]) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kvh, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kvh * hd + h * hd * d
        if self.moe is not None:
            m = self.moe
            n_exp = m.n_experts if experts_per_token is None \
                else experts_per_token
            ffn = d * m.n_experts + n_exp * (2 * d * m.d_ff + m.d_ff * d)
        else:
            ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + v * d * (
            1 if self.tie_embeddings else 2)

    @property
    def n_params(self) -> int:
        """Total parameter count as the reference counts it (a tied
        embedding once, the final norm and the qk-norm scales not)."""
        return self._count(None)

    @property
    def n_active_params(self) -> int:
        """Activated params per token (MoE: top_k experts only)."""
        return self._count(None if self.moe is None else self.moe.top_k)


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
        lp = {"norm_attn": common.rmsnorm_init(cfg.d_model, cfg.dtype, dev),
              "norm_mlp": common.rmsnorm_init(cfg.d_model, cfg.dtype, dev),
              "attn": common.attn_init(gen, spec, cfg.dtype, dev)}
        if cfg.moe is not None:
            lp["moe"] = moe_init(gen, cfg.d_model, cfg.moe, cfg.dtype, dev)
        else:
            lp["mlp"] = common.gated_mlp_init(gen, cfg.d_model, cfg.d_ff,
                                              cfg.dtype, dev)
        layers.append(lp)
    params = {"embedding": common.embed_init(gen, cfg.vocab_size,
                                             cfg.d_model, cfg.dtype, dev),
              "layers": layers,
              "final_norm": common.rmsnorm_init(cfg.d_model, cfg.dtype, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = common.embed_init(gen, cfg.vocab_size,
                                              cfg.d_model, cfg.dtype, dev)
    return params


#: Leaves whose dtype the reference's init fixes whatever `cfg.dtype` is
#: (`repro/models/moe.py:57`: the router is made in fp32).
_FIXED_DTYPES = {"router": torch.float32}


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
    Leaves are cast to `cfg.dtype`, except those in `_FIXED_DTYPES`, which
    keep the dtype the reference gives them.
    """
    dev = resolve_device(device)

    def conv(node, layer=None, key=None):
        if isinstance(node, dict):
            return {k: conv(v, layer, k) for k, v in node.items()}
        a = np.asarray(node, dtype=np.float32)
        return _to_torch(a if layer is None else a[layer],
                         _FIXED_DTYPES.get(key, cfg.dtype), dev)

    n = np.asarray(tree["layers"]["norm_attn"]["scale"]).shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"tree has {n} layers, config {cfg.n_layers}")
    out = {k: conv(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [conv(tree["layers"], i) for i in range(n)]
    return out


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------

def _mlp_block(cfg: TransformerConfig, lp: Params, x: Tensor
               ) -> Tuple[Tensor, Optional[Tensor]]:
    """x + FFN(norm(x)), and the MoE aux loss (None for a dense FFN)."""
    h = common.rmsnorm(lp["norm_mlp"], x)
    if cfg.moe is not None:
        m, aux = moe_apply(lp["moe"], cfg.moe, h)
        return x + m, aux
    return x + common.gated_mlp(lp["mlp"], h, cfg.act), None


def forward(cfg: TransformerConfig, params: Params, tokens: Tensor
            ) -> Tuple[Tensor, Tensor]:
    """tokens: [B, S] int.  Returns (logits [B, S, V] fp32, the MoE aux
    loss summed over layers, fp32; 0 for dense FFNs).
    Attention is the naive masked softmax, or with `attn_impl == "flash"`
    the blocked reference of `models/flash.py`, as in the reference."""
    x = common.embed(params, tokens)
    b, s, _ = x.shape
    spec = cfg.attn_spec()
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    mask = common.causal_mask(s, s, device=x.device).expand(b, s, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["layers"]:
        h = common.rmsnorm(lp["norm_attn"], x)
        q, k, v = common._project_qkv(lp["attn"], spec, h, positions)
        if spec.attn_impl == "flash":
            ctx = flash.flash_attention(q, k, v, spec, causal=True)
        else:
            ctx = common.mha_attend(q, k, v, mask, spec)
        x = x + common.attn_out(lp["attn"], spec, ctx)
        x, layer_aux = _mlp_block(cfg, lp, x)
        if layer_aux is not None:
            aux = aux + layer_aux
    x = common.rmsnorm(params["final_norm"], x)
    logits = common.unembed(params, x, cfg.tie_embeddings)
    return logits, aux


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
        x, _ = _mlp_block(cfg, lp, x + a)
    x = common.rmsnorm(params["final_norm"], x[:, -1:])
    logits = common.unembed(params, x, cfg.tie_embeddings)
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
        x, _ = _mlp_block(cfg, lp, x + a)
    x = common.rmsnorm(params["final_norm"], x)
    logits = common.unembed(params, x, cfg.tie_embeddings)
    return logits[:, 0], cache
