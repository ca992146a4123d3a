"""Shared model components of the port (the parts of `repro.models.common`
that llama3.2-1b and olmoe-1b-7b reach): RMSNorm, rotary embeddings, GQA
attention with optional qk-norm, the native KV cache, cached decode
attention, prefill into the cache, the gated MLP, tied or untied
embeddings and the loss.

Parameters are plain nested dicts of tensors with the reference's key
names and its `[in, out]` weight layout (``x @ w``).  Dtype policy: params
and activations in `cfg.dtype` (default bf16), softmax and logits in fp32.

KV caches are written in place (`cache["k"][:, pos] = ...`) instead of
returned as fresh copies, which saves a full cache copy per layer.  A
pooled cache therefore carries a previous call's entries; that is safe
because every position a call reads was written by the same call or is
masked (positions past `pos`, left-pad slots before `kv_start`), and every
entry ever written is finite, so a masked weight of exactly 0 times it
stays 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm as rmsnorm_op

Params = Dict[str, Any]
Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Initializers (torch generators; the JAX package's random streams differ,
# so cross-framework tests carry JAX's weights over with params_from_jax)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device, scale: Optional[float] = None) -> Tensor:
    """Truncated-normal fan-in init (LLaMA-style), [in_dim, out_dim]."""
    if scale is None:
        scale = 1.0 / math.sqrt(in_dim)
    w = torch.empty((in_dim, out_dim), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device) -> Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, dtype, device) -> Params:
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    """RMSNorm with the unit offset (apply uses 1 + scale), through the
    fused kernel (`kernels/rmsnorm/ops.py`)."""
    return rmsnorm_op(x, params["scale"], eps=eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split halves, as the reference)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> Tensor:
    """Inverse frequencies, fp32 [head_dim // 2]."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0
               ) -> Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., :, None].float() * inv          # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                   # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    logit_softcap: float = 0.0
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    rope_theta: float = 10000.0
    use_rope: bool = True
    qk_norm: bool = False                # olmoe
    sliding_window: int = 0              # 0 = full attention
    attn_impl: str = "naive"             # "naive" | "flash"


def attn_init(gen: torch.Generator, spec: AttnSpec, dtype, device
              ) -> Params:
    d, h, kvh, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, \
        spec.head_dim
    p = {"wq": dense_init(gen, d, h * hd, dtype, device),
         "wk": dense_init(gen, d, kvh * hd, dtype, device),
         "wv": dense_init(gen, d, kvh * hd, dtype, device),
         "wo": dense_init(gen, h * hd, d, dtype, device)}
    if spec.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device)
        p["k_norm"] = rmsnorm_init(hd, dtype, device)
    return p


def _project_qkv(params: Params, spec: AttnSpec, x: Tensor,
                 positions: Optional[Tensor]
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    b, s, _ = x.shape
    h, kvh, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, hd)
    k = (x @ params["wk"]).reshape(b, s, kvh, hd)
    v = (x @ params["wv"]).reshape(b, s, kvh, hd)
    if spec.qk_norm:
        # Per-head RMSNorm over head_dim, after the projections and before
        # RoPE; [B, S, H, hd] rows go through the RMSNorm kernel.
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if spec.use_rope and positions is not None:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def mha_attend(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor],
               spec: AttnSpec) -> Tensor:
    """q: [B,Sq,H,D], k/v: [B,Sk,KVH,D] -> [B,Sq,H*D].  fp32 softmax,
    masked logits filled with -1e30 (the naive path)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    groups = h // kvh
    scale = spec.query_scale if spec.query_scale is not None \
        else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, sq, kvh, groups, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float() * scale, k.float())
    if spec.logit_softcap > 0.0:
        cap = spec.logit_softcap
        logits = cap * torch.tanh(logits / cap)
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits,
                             torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h * hd)


def attn_out(params: Params, spec: AttnSpec, ctx: Tensor) -> Tensor:
    return ctx @ params["wo"]


def causal_mask(sq: int, sk: int, window: int = 0, device=None) -> Tensor:
    """[1, Sq, Sk] bool; True = attend.  Query i sees key j iff j <= i and
    (window == 0 or i - j < window)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (kpos > qpos - window)
    return m[None]


# --- KV cache ---------------------------------------------------------------

def kv_cache_init(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype, device) -> Params:
    """Per-layer native cache {"k", "v"}: [B, S, KVH, D]."""
    shape = (batch, max_len, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _pad_valid_at(pad_mask: Tensor, kpos: Tensor) -> Tensor:
    """Per-sequence validity at global key positions: pad_mask [B, P]
    (True = real token); positions >= P are always valid.  -> [B, S]."""
    p = pad_mask.shape[1]
    gathered = pad_mask[:, kpos.clamp(0, p - 1)]
    in_range = (kpos >= 0) & (kpos < p)
    return torch.where(in_range[None, :], gathered,
                       torch.ones_like(gathered))


def kv_start_of(pad_mask: Tensor) -> Tensor:
    """Left-pad invalid slots form a contiguous prefix (the engine
    contract), so the valid window starts at the pad count.  [B] int32."""
    return (~pad_mask).sum(dim=1, dtype=torch.int32)


def cached_attention(params: Params, spec: AttnSpec, x: Tensor,
                     cache: Params, pos: int,
                     pad_mask: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Params]:
    """Decode-step attention: x [B,1,D], cache k/v [B,S,KVH,HD], pos (the
    current token's global position).  The new K/V are written into the
    cache at `pos` in place.  `pad_mask` ([B, P] bool, True = real)
    invalidates left-pad prompt slots; positions >= P are always valid.
    Returns (attn output [B,1,D], cache).

    With `attn_impl == "flash"` on a plain causal layer the attention runs
    through the decode-attention kernel over the window
    [kv_start, pos + 1); otherwise the naive masked softmax below."""
    b = x.shape[0]
    s_cache = cache["k"].shape[1]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, spec, x, positions)
    cache["k"][:, pos] = k_new[:, 0]
    cache["v"][:, pos] = v_new[:, 0]
    k, v = cache["k"], cache["v"]

    # The reference's kernel route (`common.py:344-345`); the port has no
    # ring caches, so `not ring` always holds.
    if (spec.attn_impl == "flash" and spec.sliding_window == 0
            and spec.logit_softcap == 0.0):
        kv_start = None if pad_mask is None else kv_start_of(pad_mask)
        ctx = decode_attention(q[:, 0], k, v, pos + 1, kv_start,
                               scale=spec.query_scale)
        return attn_out(params, spec, ctx.reshape(b, 1, -1)), cache

    idx = torch.arange(s_cache, device=x.device)
    mask = idx <= pos
    if spec.sliding_window > 0:
        mask = mask & (idx > pos - spec.sliding_window)
    mask = mask[None, None, :]
    if pad_mask is not None:
        mask = mask & _pad_valid_at(pad_mask, idx)[:, None, :]
    ctx = mha_attend(q, k, v, mask.expand(b, 1, s_cache), spec)
    return attn_out(params, spec, ctx), cache


def prefill_into_cache(params: Params, spec: AttnSpec, x: Tensor,
                       cache: Params, pad_mask: Optional[Tensor] = None,
                       pos_offset: Optional[int] = None
                       ) -> Tuple[Tensor, Params]:
    """Prefill: write S prompt tokens into the cache (in place, at
    `pos_offset`), return the attention output [B, S, D].  `pad_mask`
    ([B, S] bool, True = real token) masks left-pad slots out of the keys
    so ragged batches match their unpadded logits.  `pos_offset` shifts
    the prompt to global positions [pos_offset, pos_offset + S) for RoPE
    and the cache write; attention itself is over the prompt alone, so the
    attention's query offset stays 0."""
    b, s, _ = x.shape
    off = 0 if pos_offset is None else int(pos_offset)
    positions = torch.arange(s, device=x.device)[None].expand(b, s) + off
    q, k, v = _project_qkv(params, spec, x, positions)
    cache["k"][:, off:off + s] = k.to(cache["k"].dtype)
    cache["v"][:, off:off + s] = v.to(cache["v"].dtype)
    if spec.attn_impl == "flash":
        kv_start = None if pad_mask is None else kv_start_of(pad_mask)
        ctx = flash_attention(q, k, v, scale=spec.query_scale, causal=True,
                              window=spec.sliding_window,
                              softcap=spec.logit_softcap, kv_start=kv_start)
        if pad_mask is not None:
            # A left-pad query row has no valid key: the kernel writes 0,
            # the reference (naive and models/flash.py alike) the mean of
            # the S values.  Attention never reads such a row, but an MoE
            # FFN routes it and it takes expert capacity, so the port
            # gives it the reference's value.
            g = spec.n_heads // spec.n_kv_heads
            vmean = v.float().mean(dim=1).repeat_interleave(g, dim=1)
            ctx = torch.where(pad_mask[:, :, None, None], ctx,
                              vmean[:, None].to(ctx.dtype))
        ctx = ctx.reshape(b, s, -1)
    else:
        mask = causal_mask(s, s, window=spec.sliding_window,
                           device=x.device)
        if pad_mask is not None:
            mask = mask & pad_mask[:, None, :]
        ctx = mha_attend(q, k, v, mask.expand(b, s, s), spec)
    return attn_out(params, spec, ctx), cache


# ---------------------------------------------------------------------------
# MLP, embedding, loss
# ---------------------------------------------------------------------------

ACTS = {"silu": F.silu}


def gated_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                   device) -> Params:
    return {"w_gate": dense_init(gen, d_model, d_ff, dtype, device),
            "w_up": dense_init(gen, d_model, d_ff, dtype, device),
            "w_down": dense_init(gen, d_ff, d_model, dtype, device)}


def gated_mlp(params: Params, x: Tensor, act: str = "silu") -> Tensor:
    """SwiGLU."""
    h = ACTS[act](x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


def embed(params: Params, tokens: Tensor) -> Tensor:
    return params["embedding"][tokens]


def unembed(params: Params, x: Tensor, tied: bool = True) -> Tensor:
    """Unembedding through the embedding table (tied) or `lm_head` (both
    [V, D]); logits in fp32."""
    table = params["embedding"] if tied else params["lm_head"]
    return (x @ table.T).float()


def cross_entropy_loss(logits: Tensor, labels: Tensor,
                       ignore_id: int = -100) -> Tensor:
    """Mean token NLL in fp32; `ignore_id` labels are masked out."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    safe = labels.clamp_min(0)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - gold
    w = (labels != ignore_id).float()
    return (nll * w).sum() / w.sum().clamp_min(1.0)
