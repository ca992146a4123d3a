"""Encoder-decoder transformer of the port (`repro.models.encdec`): the
SeamlessM4T-large-v2 text/speech backbone (arXiv:2308.11596), for
inference and training.

The modality frontend is a stub, as in the reference: `speech_embeddings`
(precomputed conformer-frame embeddings, [B, T_frames, D];
`models/frontends.AudioStub`) feed the encoder directly.  The encoder is
bidirectional; the decoder is a pre-LN causal transformer with cross
attention into the encoder memory.  Positions are absolute sinusoids, no
RoPE.  The config sets no `attn_impl`, so every attention here is the
naive masked softmax, as in the reference: this family launches none of
the port's kernels (the encoder's bidirectional attention is not what the
causal prefill kernel computes).

Public API (used by the registry, the engine and the tests):
    init_params(cfg, seed, device)       -> params
    params_from_jax(cfg, tree, device)   -> params from JAX's params tree
    encode(cfg, params, speech)          -> memory [B, T, D]
    forward(cfg, params, {"speech_embeddings", "tokens"}) -> (logits, 0)
    loss_fn(cfg, params, {"speech_embeddings", "tokens", "labels"})
                                         -> scalar loss
    init_cache(cfg, batch, max_len, device) -> cache
    prefill(cfg, params, {"speech_embeddings", "tokens"}, cache)
                                         -> (BOS logits, cache)
    decode_step(cfg, params, token, cache, pos) -> (logits, cache)

Params keep the reference's keys and `[in, out]` weight layout;
`params["enc_layers"]` and `params["dec_layers"]` are lists of per-layer
dicts (the reference stacks each for `lax.scan`; their counts may
differ).  The cache keeps the reference's layout — "self" and "cross"
K/V stacked over the decoder's layers, `[L, B, S, KVH, D]`, and
"memory_len", a 0-d int32 — and is written in place: prefill writes the
cross K/V of the memory's T frames and `memory_len`, a decode step its
token's self K/V at `pos`.  Stale entries of a reused cache are never
read: cross attention masks frames past `memory_len`, self attention
positions past `pos`.  Training differentiates `forward` through
autograd (no kernel is on its path); `cfg.remat` takes "none", "dots" and
"full" and, as in the reference (whose encdec never reads it), recomputes
nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.models import common
from repro_torch.models.common import AttnSpec

Params = Dict[str, Any]
Tensor = torch.Tensor

#: The recurrent state a reused cache zeroes before a new prompt: none
#: (stale K/V entries are masked, see the module docstring).
STATE_KEYS = ()


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc_layers: int
    n_dec_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    act: str = "relu"
    max_source_len: int = 4096
    max_target_len: int = 4096
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = True
    remat: str = "none"

    def __post_init__(self):
        if self.remat not in common.REMAT:
            raise ValueError(f"remat must be one of {common.REMAT}, got "
                             f"{self.remat!r}")

    def attn_spec(self) -> AttnSpec:
        return AttnSpec(d_model=self.d_model, n_heads=self.n_heads,
                        n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
                        use_bias=True, use_rope=False)

    @property
    def n_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        h, kvh, hd = self.n_heads, self.n_kv_heads, self.head_dim
        attn = d * h * hd + 2 * d * kvh * hd + h * hd * d + 2 * h * hd \
            + 2 * kvh * hd + d
        mlp = 2 * d * f + f + d
        enc = self.n_enc_layers * (attn + mlp + 4 * d)
        dec = self.n_dec_layers * (2 * attn + mlp + 6 * d)
        return enc + dec + v * d * (1 if self.tie_embeddings else 2)

    @property
    def n_active_params(self) -> int:
        return self.n_params


# ---------------------------------------------------------------------------
# Init and weights from JAX
# ---------------------------------------------------------------------------

def init_params(cfg: EncDecConfig, seed: int = 0, device=None) -> Params:
    """Random weights from a torch generator seeded with `seed`, made on
    `device` (CUDA unless told otherwise; on the meta device, shapes and
    dtypes alone)."""
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    spec, d, dt = cfg.attn_spec(), cfg.d_model, cfg.dtype

    def norm():
        return common.layernorm_init(d, dt, dev)

    def attn():
        return common.attn_init(gen, spec, dt, dev)

    def mlp():
        return common.mlp_init(gen, d, cfg.d_ff, dt, dev)

    params = {"embedding": common.embed_init(gen, cfg.vocab_size, d, dt,
                                             dev)}
    params["enc_layers"] = [
        {"norm_attn": norm(), "norm_mlp": norm(), "attn": attn(),
         "mlp": mlp()} for _ in range(cfg.n_enc_layers)]
    params["dec_layers"] = [
        {"norm_self": norm(), "norm_cross": norm(), "norm_mlp": norm(),
         "self_attn": attn(), "cross_attn": attn(), "mlp": mlp()}
        for _ in range(cfg.n_dec_layers)]
    params["enc_final_norm"] = norm()
    params["dec_final_norm"] = norm()
    return params


def params_from_jax(cfg: EncDecConfig, tree: Params, device=None) -> Params:
    """The port's params from the JAX params tree of the same config
    (`common.params_from_jax_tree` over its two layer stacks), every leaf
    in `cfg.dtype`."""
    return common.params_from_jax_tree(
        tree, {"enc_layers": cfg.n_enc_layers,
               "dec_layers": cfg.n_dec_layers},
        lambda key: cfg.dtype, resolve_device(device))


# ---------------------------------------------------------------------------
# Cross attention (decoder queries over encoder memory)
# ---------------------------------------------------------------------------

def _cross_attention(params: Params, spec: AttnSpec, x: Tensor,
                     memory_kv: Tuple[Tensor, Tensor],
                     memory_mask: Optional[Tensor]) -> Tensor:
    b, s, _ = x.shape
    q = x @ params["wq"]
    if "bq" in params:
        q = q + params["bq"]
    q = q.reshape(b, s, spec.n_heads, spec.head_dim)
    k, v = memory_kv
    ctx = common.mha_attend(q, k, v, memory_mask, spec)
    return common.attn_out(params, spec, ctx)


def _memory_kv(params: Params, spec: AttnSpec, memory: Tensor
               ) -> Tuple[Tensor, Tensor]:
    b, t, _ = memory.shape
    k, v = memory @ params["wk"], memory @ params["wv"]
    if "bk" in params:
        k, v = k + params["bk"], v + params["bv"]
    shape = (b, t, spec.n_kv_heads, spec.head_dim)
    return k.reshape(shape), v.reshape(shape)


# ---------------------------------------------------------------------------
# Encoder and teacher-forced decoder
# ---------------------------------------------------------------------------

def _speech_and_tokens(inputs) -> Tuple[Tensor, Tensor]:
    if isinstance(inputs, dict):
        return inputs["speech_embeddings"], inputs["tokens"]
    return inputs


def encode(cfg: EncDecConfig, params: Params, speech_embeddings: Tensor
           ) -> Tensor:
    """speech_embeddings: [B, T, D] (frontend stub).  Bidirectional."""
    spec = cfg.attn_spec()
    x = speech_embeddings.to(cfg.dtype)
    t = x.shape[1]
    x = x + common.sinusoidal_positions(t, cfg.d_model, x.device)[None] \
        .to(x.dtype)
    mask = torch.ones((1, t, t), dtype=torch.bool, device=x.device)
    for lp in params["enc_layers"]:
        h = common.layernorm(lp["norm_attn"], x)
        x = x + common.self_attention(lp["attn"], spec, h, None, mask)
        h = common.layernorm(lp["norm_mlp"], x)
        x = x + common.mlp(lp["mlp"], h, cfg.act)
    return common.layernorm(params["enc_final_norm"], x)


def decode_train(cfg: EncDecConfig, params: Params, memory: Tensor,
                 tokens: Tensor) -> Tensor:
    """Teacher-forced decoder logits [B, S, V] (fp32) over `memory`."""
    spec = cfg.attn_spec()
    s = tokens.shape[1]
    x = common.embed(params, tokens)
    x = x + common.sinusoidal_positions(s, cfg.d_model, x.device)[None] \
        .to(x.dtype)
    cmask = common.causal_mask(s, s, device=x.device)
    for lp in params["dec_layers"]:
        h = common.layernorm(lp["norm_self"], x)
        x = x + common.self_attention(lp["self_attn"], spec, h, None, cmask)
        h = common.layernorm(lp["norm_cross"], x)
        kv = _memory_kv(lp["cross_attn"], spec, memory)
        x = x + _cross_attention(lp["cross_attn"], spec, h, kv, None)
        h = common.layernorm(lp["norm_mlp"], x)
        x = x + common.mlp(lp["mlp"], h, cfg.act)
    x = common.layernorm(params["dec_final_norm"], x)
    return common.unembed(params, x, cfg.tie_embeddings)


def forward(cfg: EncDecConfig, params: Params, batch_inputs,
            prefix_embeddings: Optional[Tensor] = None
            ) -> Tuple[Tensor, Tensor]:
    """batch_inputs: {"speech_embeddings", "tokens"} or the (speech, tokens)
    pair.  Returns (logits [B, S, V] fp32, aux = 0)."""
    speech, tokens = _speech_and_tokens(batch_inputs)
    memory = encode(cfg, params, speech)
    logits = decode_train(cfg, params, memory, tokens)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def loss_fn(cfg: EncDecConfig, params: Params, batch: Dict[str, Tensor]
            ) -> Tensor:
    """Mean next-token cross entropy of the teacher-forced decoder, fp32
    scalar.  `batch`: "speech_embeddings" [B, T, D], "tokens" and "labels"
    [B, S] int."""
    logits, aux = forward(cfg, params, batch)
    return common.cross_entropy_loss(logits, batch["labels"].long()) + aux


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg: EncDecConfig, batch: int, max_len: int,
               device=None) -> Params:
    """Self-attention K/V of the decoder ([L, B, min(max_len,
    max_target_len), KVH, D]), the cross K/V prefill fills ([L, B,
    min(max_len, max_source_len), KVH, D]) and `memory_len`."""
    dev = resolve_device(device)
    tl = min(max_len, cfg.max_target_len)
    sl = min(max_len, cfg.max_source_len)
    kvh, hd, n = cfg.n_kv_heads, cfg.head_dim, cfg.n_dec_layers

    def zeros(length):
        return torch.zeros((n, batch, length, kvh, hd), dtype=cfg.dtype,
                           device=dev)
    return {"self": {"k": zeros(tl), "v": zeros(tl)},
            "cross": {"k": zeros(sl), "v": zeros(sl)},
            "memory_len": torch.zeros((), dtype=torch.int32, device=dev)}


def prefill(cfg: EncDecConfig, params: Params, inputs, cache: Params,
            prefix_embeddings: Optional[Tensor] = None,
            attn_mask: Optional[Tensor] = None,
            pos_offset: Optional[int] = None) -> Tuple[Tensor, Params]:
    """Encode the speech, write each decoder layer's cross K/V of the
    memory and `memory_len` into the cache (in place), and feed BOS
    (`tokens[:, 0]`) through one decode step at position 0.  `attn_mask`
    is accepted for the engine's API and unused: the target side starts
    from a single BOS token, and cross attention masks by `memory_len`.
    `pos_offset` is refused: sinusoidal positions are absolute, so
    admission at a global clock offset would change the encoding (the
    engine's continuous batching refuses this family)."""
    del attn_mask
    if pos_offset is not None:
        raise NotImplementedError(
            "encdec uses absolute sinusoidal positions; prefill at a "
            "pos_offset (continuous-batching admission) is unsupported")
    speech, tokens = _speech_and_tokens(inputs)
    memory = encode(cfg, params, speech)
    spec = cfg.attn_spec()
    t = memory.shape[1]
    cross = cache["cross"]
    for i, lp in enumerate(params["dec_layers"]):
        k, v = _memory_kv(lp["cross_attn"], spec, memory)
        cross["k"][i, :, :t] = k
        cross["v"][i, :, :t] = v
    cache["memory_len"].fill_(t)
    return decode_step(cfg, params, tokens[:, 0], cache, 0)


def decode_step(cfg: EncDecConfig, params: Params, token: Tensor,
                cache: Params, pos, attn_mask: Optional[Tensor] = None
                ) -> Tuple[Tensor, Params]:
    """token: [B] int; pos: its target position, an int or a 0-d integer
    tensor on the device (`common.as_pos`: nothing here reads it on the
    host, so the step can be captured in a CUDA graph).  The position's
    sinusoid is computed for its row alone (`common.sinusoidal_position`),
    with `pos` clamped to the table's last row as the reference's
    `dynamic_slice` clamps it.  Returns (logits [B, V] fp32, cache)."""
    del attn_mask  # see prefill
    spec = cfg.attn_spec()
    b = token.shape[0]
    pos = common.as_pos(pos, token.device)
    x = common.embed(params, token[:, None])
    row = common.sinusoidal_position(pos.clamp_max(cfg.max_target_len - 1),
                                     cfg.d_model, x.device)
    x = x + row[None].to(x.dtype)
    sl = cache["cross"]["k"].shape[2]
    cross_mask = (torch.arange(sl, device=x.device) < cache["memory_len"])
    cross_mask = cross_mask[None, None, :].expand(b, 1, sl)
    for i, lp in enumerate(params["dec_layers"]):
        h = common.layernorm(lp["norm_self"], x)
        layer_cache = {"k": cache["self"]["k"][i], "v": cache["self"]["v"][i]}
        a, _ = common.cached_attention(lp["self_attn"], spec, h, layer_cache,
                                       pos)
        x = x + a
        h = common.layernorm(lp["norm_cross"], x)
        kv = (cache["cross"]["k"][i], cache["cross"]["v"][i])
        x = x + _cross_attention(lp["cross_attn"], spec, h, kv, cross_mask)
        h = common.layernorm(lp["norm_mlp"], x)
        x = x + common.mlp(lp["mlp"], h, cfg.act)
    x = common.layernorm(params["dec_final_norm"], x)
    return common.unembed(params, x, cfg.tie_embeddings)[:, 0], cache
