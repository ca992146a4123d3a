"""Decoder-only transformer LM of the port, the counterpart of
`repro.models.transformer`: the dense/GQA family (llama, smollm, qwen2 and
qwen2.5 with q/k/v biases, starcoder2 with LayerNorm, biases and a dense
GELU MLP, the phi-3-vision backbone with a prefix of patch embeddings),
gemma2 (local/global interleave, attention and final logit softcaps,
sandwich post-norms, sqrt(d) embedding scale, query scale) and MoE FFNs
(olmoe, mixtral with ring-cached local layers), with a native or int8 KV
cache.

Public API (used by serving/, launch/ and the tests):
    init_params(cfg, seed, device)       -> params
    params_from_jax(cfg, tree, device)   -> params from JAX's params tree
    forward(cfg, params, tokens, prefix_embeddings=None) -> (logits, aux)
    loss_fn(cfg, params, batch)          -> scalar loss
    init_cache(cfg, batch, max_len, device) -> cache
    prefill(cfg, params, tokens, cache)  -> (last logits, cache)
    decode_step(cfg, params, token, cache, pos) -> (logits, cache)

Params keep the reference's key names and `[in, out]` weight layout.
The reference stacks layer params on a leading `[layers, ...]` axis for
`lax.scan`; here `params["layers"]` is a list of per-layer dicts (the loop
over layers is a Python loop).  The cache keeps the reference's stacked
groups, `"global"` and `"local"` (each `[n, B, S, KVH, D]`, present when
the pattern has such layers; local layers get a ring of `sliding_window`
slots when the cache is longer), and layer i writes its slice of its
group in place, at its index among the group's layers in layer order
(`layer_slots`), as the reference's `_split_layers` orders them.

Training differentiates `forward` through autograd: the RMSNorm and
grouped-GEMM kernels carry backward kernels of their own
(`kernels/rmsnorm/ops.py`, `kernels/moe_gemm/ops.py`).  `cfg.remat`
recomputes each block in the backward: "full" keeps only the block's
input (`torch.utils.checkpoint`, the reference's `nothing_saveable`),
"dots" also keeps the outputs of its matrix products (selective
checkpointing, the reference's `checkpoint_dots`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch._device import resolve_device
from repro_torch.models import common, flash
from repro_torch.models.common import AttnSpec
from repro_torch.models.moe import MoEConfig, moe_apply, moe_init

Params = Dict[str, Any]
Tensor = torch.Tensor

#: The recurrent state a reused cache zeroes before a new prompt: none (a
#: KV cache needs no reset: stale entries are masked or rewritten).
STATE_KEYS = ()

#: The values each enumerated field takes.
_CHOICES = {"norm": ("rmsnorm", "layernorm"), "mlp_kind": ("gated", "dense"),
            "attn_impl": ("naive", "flash"),
            "kv_cache_dtype": ("native", "int8"),
            "remat": common.REMAT}


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
    mlp_kind: str = "gated"        # "gated" (SwiGLU/GeGLU) | "dense"
    act: str = "silu"
    use_bias: bool = False         # bias on mlp + attn out (starcoder2)
    qkv_bias: bool = False         # qwen2
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True
    attn_softcap: float = 0.0      # gemma2: 50
    final_softcap: float = 0.0     # gemma2: 30
    query_scale: Optional[float] = None
    qk_norm: bool = False          # olmoe
    embed_scale: bool = False      # gemma: sqrt(d) input scaling
    post_norms: bool = False       # gemma2 sandwich norms
    sliding_window: int = 0
    layer_pattern: Tuple[str, ...] = ("global",)  # cycled over layers
    attn_impl: str = "naive"       # "naive" | "flash"
    kv_cache_dtype: str = "native"  # "native" (cfg.dtype) | "int8"
    moe: Optional[MoEConfig] = None
    num_prefix_embeddings: int = 0  # VLM stub prefix slots
    dtype: Any = torch.bfloat16
    max_seq_len: int = 131072
    # remat policy for training: "none" | "dots" | "full"
    remat: str = "none"

    def __post_init__(self):
        for field, allowed in _CHOICES.items():
            if getattr(self, field) not in allowed:
                raise ValueError(f"{field} must be one of {allowed}, got "
                                 f"{getattr(self, field)!r}")
        if not self.layer_pattern or any(
                p not in ("local", "global") for p in self.layer_pattern):
            raise ValueError(f"layer_pattern must be a non-empty tuple of "
                             f"'local'/'global', got {self.layer_pattern!r}")

    @property
    def is_local(self) -> Tuple[bool, ...]:
        pat = self.layer_pattern
        return tuple(pat[i % len(pat)] == "local"
                     for i in range(self.n_layers))

    def attn_spec(self) -> AttnSpec:
        return AttnSpec(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            use_bias=self.use_bias, qkv_bias_only=self.qkv_bias,
            logit_softcap=self.attn_softcap, query_scale=self.query_scale,
            rope_theta=self.rope_theta, use_rope=self.use_rope,
            qk_norm=self.qk_norm, sliding_window=self.sliding_window,
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
        elif self.mlp_kind == "gated":
            ffn = 3 * d * f
        else:
            ffn = 2 * d * f
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + v * d * (
            1 if self.tie_embeddings else 2)

    @property
    def n_params(self) -> int:
        """Total parameter count as the reference counts it (a tied
        embedding once; biases, post-norms, the final norm and the qk-norm
        scales not)."""
        return self._count(None)

    @property
    def n_active_params(self) -> int:
        """Activated params per token (MoE: top_k experts only)."""
        return self._count(None if self.moe is None else self.moe.top_k)


def cache_len(cfg: TransformerConfig, max_len: int, layer_local: bool) -> int:
    """Ring length for local layers (the window, when the cache is longer);
    the full length for global ones."""
    if layer_local and cfg.sliding_window and max_len > cfg.sliding_window:
        return cfg.sliding_window
    return max_len


def layer_slots(cfg: TransformerConfig) -> List[Tuple[str, int]]:
    """(cache group, index in the group) of each layer: the group's layers
    in layer order, as the reference's `_split_layers` (`np.nonzero` of the
    local flags) stacks them."""
    seen = {"global": 0, "local": 0}
    slots = []
    for local in cfg.is_local:
        group = "local" if local else "global"
        slots.append((group, seen[group]))
        seen[group] += 1
    return slots


# ---------------------------------------------------------------------------
# Init and weights from JAX
# ---------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> Params:
    """Random weights from a torch generator seeded with `seed`, made on
    `device` (CUDA unless told otherwise; on the meta device, shapes and
    dtypes alone)."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    spec = cfg.attn_spec()
    norm_init, _ = common.make_norm(cfg.norm)
    d, dt = cfg.d_model, cfg.dtype
    layers = []
    for _ in range(cfg.n_layers):
        lp = {"norm_attn": norm_init(d, dt, dev),
              "norm_mlp": norm_init(d, dt, dev),
              "attn": common.attn_init(gen, spec, dt, dev)}
        if cfg.post_norms:
            lp["post_norm_attn"] = norm_init(d, dt, dev)
            lp["post_norm_mlp"] = norm_init(d, dt, dev)
        if cfg.moe is not None:
            lp["moe"] = moe_init(gen, d, cfg.moe, dt, dev)
        elif cfg.mlp_kind == "gated":
            lp["mlp"] = common.gated_mlp_init(gen, d, cfg.d_ff, dt, dev,
                                              cfg.use_bias)
        else:
            lp["mlp"] = common.mlp_init(gen, d, cfg.d_ff, dt, dev,
                                        cfg.use_bias)
        layers.append(lp)
    params = {"embedding": common.embed_init(gen, cfg.vocab_size, d, dt, dev),
              "layers": layers,
              "final_norm": norm_init(d, dt, dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = common.embed_init(gen, cfg.vocab_size, d, dt,
                                              dev)
    return params


#: Leaves whose dtype the reference's init fixes whatever `cfg.dtype` is
#: (`repro/models/moe.py:57`: the router is made in fp32).
_FIXED_DTYPES = {"router": torch.float32}


def params_from_jax(cfg: TransformerConfig, tree: Params,
                    device=None) -> Params:
    """The port's params from the JAX params tree of the same config
    (`common.params_from_jax_tree`: keys kept, the `[layers, ...]` axis
    unstacked, no transpose), every leaf included (biases, post-norms,
    LayerNorm biases).  Leaves are cast to `cfg.dtype`, except those in
    `_FIXED_DTYPES`, which keep the dtype the reference gives them.
    """
    return common.params_from_jax_tree(
        tree, {"layers": cfg.n_layers},
        lambda key: _FIXED_DTYPES.get(key, cfg.dtype),
        resolve_device(device))


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------

def _layer_spec(cfg: TransformerConfig, spec: AttnSpec, local: bool
                ) -> AttnSpec:
    """A layer's attention: the window on local layers, none on global."""
    return dataclasses.replace(
        spec, sliding_window=cfg.sliding_window if local else 0)


def _block(cfg: TransformerConfig, lp: Params, x: Tensor, attend
           ) -> Tuple[Tensor, Optional[Tensor]]:
    """One layer: x + post(attend(norm(x))), then x + post(FFN(norm(x))),
    the post-norms where the config has them.  Returns (x, the MoE aux
    loss, None for a dense FFN)."""
    _, norm = common.make_norm(cfg.norm)
    a = attend(norm(lp["norm_attn"], x))
    if cfg.post_norms:
        a = norm(lp["post_norm_attn"], a)
    x = x + a
    h = norm(lp["norm_mlp"], x)
    aux = None
    if cfg.moe is not None:
        m, aux = moe_apply(lp["moe"], cfg.moe, h)
    elif cfg.mlp_kind == "gated":
        m = common.gated_mlp(lp["mlp"], h, cfg.act)
    else:
        m = common.mlp(lp["mlp"], h, cfg.act)
    if cfg.post_norms:
        m = norm(lp["post_norm_mlp"], m)
    return x + m, aux


def _head(cfg: TransformerConfig, params: Params, x: Tensor) -> Tensor:
    _, norm = common.make_norm(cfg.norm)
    return common.unembed(params, norm(params["final_norm"], x),
                          cfg.tie_embeddings, cfg.final_softcap)


def _embed(cfg: TransformerConfig, params: Params, tokens: Tensor,
           prefix_embeddings: Optional[Tensor]) -> Tensor:
    """Token embeddings ([B, S, D], sqrt(d)-scaled where the config says),
    after the prefix's [B, P, D] where one is given."""
    x = common.embed(params, tokens, cfg.embed_scale)
    if prefix_embeddings is not None:
        x = torch.cat([prefix_embeddings.to(x.dtype), x], dim=1)
    return x


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------

#: The ops whose outputs remat "dots" keeps: the matrix products (aten's
#: matmul decomposes into these) and the grouped GEMM's custom op.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default,
         torch.ops.repro_torch.grouped_gemm.default)


def _save_dots(ctx, op, *args, **kwargs):
    policy = torch_checkpoint.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def _remat(cfg: TransformerConfig, fn):
    """`fn` recomputed in the backward as `cfg.remat` says (where autograd
    records; otherwise `fn` itself)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _save_dots)
    return functools.partial(torch_checkpoint.checkpoint, fn,
                             use_reentrant=False, **kw)


def forward(cfg: TransformerConfig, params: Params, tokens: Tensor,
            prefix_embeddings: Optional[Tensor] = None
            ) -> Tuple[Tensor, Tensor]:
    """tokens: [B, S] int; prefix_embeddings: optional [B, P, D] modality
    stub, prepended (logits are returned for the token positions only).
    Returns (logits [B, S, V] fp32, the MoE aux loss summed over layers,
    fp32; 0 for dense FFNs).  Attention is the naive masked softmax, or
    with `attn_impl == "flash"` the blocked reference of `models/flash.py`,
    as in the reference; local layers see the sliding window.  Each block
    is recomputed in the backward as `cfg.remat` says."""
    x = _embed(cfg, params, tokens, prefix_embeddings)
    b, s, _ = x.shape
    spec = cfg.attn_spec()
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block = _remat(cfg, _block)
    for lp, local in zip(params["layers"], cfg.is_local):
        lspec = _layer_spec(cfg, spec, local)

        def attend(h, lp=lp, lspec=lspec):
            q, k, v = common._project_qkv(lp["attn"], lspec, h, positions)
            if lspec.attn_impl == "flash":
                ctx = flash.flash_attention(q, k, v, lspec, causal=True)
            else:
                mask = common.causal_mask(s, s, window=lspec.sliding_window,
                                          device=x.device)
                ctx = common.mha_attend(q, k, v, mask.expand(b, s, s), lspec)
            return common.attn_out(lp["attn"], lspec, ctx)
        x, layer_aux = block(cfg, lp, x, attend)
        if layer_aux is not None:
            aux = aux + layer_aux
    if prefix_embeddings is not None:
        x = x[:, prefix_embeddings.shape[1]:]
    return _head(cfg, params, x), aux


#: Mean next-token cross entropy plus the MoE aux loss (`common.lm_loss`;
#: `batch` may add "prefix_embeddings").
loss_fn = functools.partial(common.lm_loss, forward)


# ---------------------------------------------------------------------------
# KV-cache inference
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> Params:
    """The reference's cache groups, each stacked over its layers:
    "global" ([n_global, B, max_len, KVH, D] per leaf) and "local" (the
    same over `cache_len` slots), each present when the pattern has such
    layers.  An int8 cache adds the fp32 scale leaves, [n, B, S, KVH, 1]."""
    dev = resolve_device(device)
    dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else cfg.dtype
    n_local = sum(cfg.is_local)
    cache: Params = {}
    for group, n, local in (("global", cfg.n_layers - n_local, False),
                            ("local", n_local, True)):
        if n:
            one = common.kv_cache_init(batch, cache_len(cfg, max_len, local),
                                       cfg.n_kv_heads, cfg.head_dim, dtype,
                                       dev)
            cache[group] = {k: torch.zeros((n,) + a.shape, dtype=a.dtype,
                                           device=dev)
                            for k, a in one.items()}
    return cache


def _layer_cache(cache: Params, group: str, i: int) -> Params:
    return {name: leaf[i] for name, leaf in cache[group].items()}


def _cached_layers(cfg: TransformerConfig, cache: Params):
    """(layer spec, its cache slice, ring) for each layer, in order.  A
    local layer's cache is a ring when its length is the window."""
    spec = cfg.attn_spec()
    for (group, i), local in zip(layer_slots(cfg), cfg.is_local):
        c = _layer_cache(cache, group, i)
        ring = local and c["k"].shape[1] == cfg.sliding_window
        yield _layer_spec(cfg, spec, local), c, ring


def prefill(cfg: TransformerConfig, params: Params, tokens: Tensor,
            cache: Params, prefix_embeddings: Optional[Tensor] = None,
            attn_mask: Optional[Tensor] = None,
            pos_offset: Optional[int] = None) -> Tuple[Tensor, Params]:
    """Run the prompt through the model, filling the cache in place.
    `prefix_embeddings` ([B, P, D]) are prepended to the tokens and take
    positions [0, P).  `attn_mask` ([B, S] bool, True = real token) masks
    left-padded slots out of every layer's keys; prefix slots are always
    valid.  `pos_offset` shifts the prompt to global positions
    [pos_offset, pos_offset + S) in RoPE and the cache writes.
    Returns (logits for the last position [B, V], cache).

    Under `attn_impl == "flash"` a prefix before left pads reaches the
    kernels as `prefix_len`: a row's valid keys are the P prefix slots and
    the real tokens after its pads."""
    x = _embed(cfg, params, tokens, prefix_embeddings)
    p = 0
    if prefix_embeddings is not None and attn_mask is not None:
        p = prefix_embeddings.shape[1]
        attn_mask = torch.cat([torch.ones((x.shape[0], p), dtype=torch.bool,
                                          device=x.device), attn_mask], dim=1)
    for lp, (lspec, c, ring) in zip(params["layers"],
                                    _cached_layers(cfg, cache)):
        def attend(h, lp=lp, lspec=lspec, c=c, ring=ring):
            return common.prefill_into_cache(
                lp["attn"], lspec, h, c, ring=ring, pad_mask=attn_mask,
                pos_offset=pos_offset, prefix_len=p)[0]
        x, _ = _block(cfg, lp, x, attend)
    return _head(cfg, params, x[:, -1:])[:, 0], cache


def decode_step(cfg: TransformerConfig, params: Params, token: Tensor,
                cache: Params, pos, attn_mask: Optional[Tensor] = None
                ) -> Tuple[Tensor, Params]:
    """token: [B] int; pos: global position of `token`, an int or a 0-d
    integer tensor on the device (`common.as_pos`; the engine's captured
    step passes the latter).  `attn_mask` ([B, P] bool over global
    positions, True = real token) keeps left-padded prompt slots masked;
    positions >= P are always valid.  Returns (logits [B, V], cache)."""
    pos = common.as_pos(pos, token.device)
    x = common.embed(params, token[:, None], cfg.embed_scale)
    for lp, (lspec, c, ring) in zip(params["layers"],
                                    _cached_layers(cfg, cache)):
        def attend(h, lp=lp, lspec=lspec, c=c, ring=ring):
            return common.cached_attention(lp["attn"], lspec, h, c, pos,
                                           ring=ring, pad_mask=attn_mask)[0]
        x, _ = _block(cfg, lp, x, attend)
    return _head(cfg, params, x)[:, 0], cache
