"""Shared model components of the port (`repro.models.common`): RMSNorm,
LayerNorm, rotary embeddings and the sinusoidal position table (with its
one-row form), GQA attention with optional qk-norm,
q/k/v and output biases and a logit softcap, the native or int8 KV cache as
a plain or a ring (sliding-window) buffer, cached decode attention, prefill
into the cache, the gated MLP (SwiGLU and GeGLU) and the dense one, tied or
untied embeddings with the optional sqrt(d) scale and final softcap, the
loss, and the conversion of a JAX params tree.

Parameters are plain nested dicts of tensors with the reference's key
names and its `[in, out]` weight layout (``x @ w``).  Dtype policy: params
and activations in `cfg.dtype` (default bf16), softmax and logits in fp32.

KV caches are written in place (`index_copy_` at slot `pos`) instead of
returned as fresh copies, which saves a full cache copy per layer.  An int8
cache writes its codes and per-(token, head) scales in place the same way,
and a step reads it dequantized whole, as the reference does.  A
pooled cache therefore carries a previous call's entries; that is safe
because every position a call reads was written by the same call or is
masked (positions past `pos`, left-pad slots before `kv_start`, ring
slots whose global position would be negative), and every entry ever
written is finite, so a masked weight of exactly 0 times it stays 0.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
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


def layernorm_init(dim: int, dtype, device) -> Params:
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: Params, x: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm over the last axis in fp32 with `(1 + scale)` and `bias`,
    cast back to x's dtype.  The JAX package has no LayerNorm kernel, so
    this is plain PyTorch."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    out = xf * (1.0 + params["scale"].float()) + params["bias"].float()
    return out.to(x.dtype)


def make_norm(kind: str) -> Tuple[Callable, Callable]:
    """(init, apply) of the norm `kind`: "rmsnorm" or "layernorm"."""
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm
    if kind == "layernorm":
        return layernorm_init, layernorm
    raise ValueError(f"unknown norm {kind!r}")


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


def _sinusoidal_angles(pos: Tensor, dim: int) -> Tensor:
    """fp32 angles [len(pos), dim // 2] of fp32 positions `pos`: the
    reference's `pos * exp(-log(10000) * i / half)`, element for element."""
    half = dim // 2
    div = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=pos.device) / half)
    return pos[:, None] * div[None, :]


def sinusoidal_positions(max_len: int, dim: int, device=None) -> Tensor:
    """Classic sin/cos absolute position table [max_len, dim] (fp32)."""
    ang = _sinusoidal_angles(torch.arange(max_len, dtype=torch.float32,
                                          device=device), dim)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoidal_position(pos, dim: int, device=None) -> Tensor:
    """Row `pos` of `sinusoidal_positions(max_len, dim)`, [1, dim], made with
    the same fp32 operations on that row alone (a decode step needs one
    row, and the table at 32768 x 1024 is 134 MB).  `pos` is an int or a
    0-d integer tensor on the device (`as_pos`), read on the device."""
    ang = _sinusoidal_angles(as_pos(pos, device).float().reshape(1), dim)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    use_bias: bool = False               # q/k/v and output bias (starcoder2)
    qkv_bias_only: bool = False          # q/k/v bias alone (qwen2)
    logit_softcap: float = 0.0           # gemma2: 50
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
    if spec.use_bias or spec.qkv_bias_only:
        p["bq"] = torch.zeros((h * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kvh * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kvh * hd,), dtype=dtype, device=device)
        if spec.use_bias and not spec.qkv_bias_only:
            p["bo"] = torch.zeros((d,), dtype=dtype, device=device)
    if spec.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, device)
        p["k_norm"] = rmsnorm_init(hd, dtype, device)
    return p


def _project_qkv(params: Params, spec: AttnSpec, x: Tensor,
                 positions: Optional[Tensor]
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    b, s, _ = x.shape
    h, kvh, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q, k, v = x @ params["wq"], x @ params["wk"], x @ params["wv"]
    if "bq" in params:
        # Added after the product, each rounded to x's dtype, as the
        # reference's einsum then `+ b`.
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kvh, hd)
    v = v.reshape(b, s, kvh, hd)
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
    out = ctx @ params["wo"]
    if "bo" in params:
        out = out + params["bo"]
    return out


def causal_mask(sq: int, sk: int, window: int = 0, device=None) -> Tensor:
    """[1, Sq, Sk] bool; True = attend.  Query i sees key j iff j <= i and
    (window == 0 or i - j < window)."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m = m & (kpos > qpos - window)
    return m[None]


def self_attention(params: Params, spec: AttnSpec, x: Tensor,
                   positions: Optional[Tensor],
                   mask: Optional[Tensor] = None) -> Tensor:
    """Full-sequence self-attention without a cache (the encoder-decoder's
    layers).  `attn_impl == "flash"` runs the blocked reference of
    `models/flash.py`, causal; otherwise the naive masked softmax over
    `mask` ([B or 1, Sq, Sk] bool), causal (with the spec's window) when
    none is given, as the reference routes it."""
    q, k, v = _project_qkv(params, spec, x, positions)
    if spec.attn_impl == "flash":
        from repro_torch.models import flash
        ctx = flash.flash_attention(q, k, v, spec, causal=True)
    else:
        s = x.shape[1]
        if mask is None:
            mask = causal_mask(s, s, window=spec.sliding_window,
                               device=x.device)
        ctx = mha_attend(q, k, v, mask.expand(x.shape[0], s, s), spec)
    return attn_out(params, spec, ctx)


# --- KV cache ---------------------------------------------------------------

def kv_cache_init(batch: int, max_len: int, n_kv_heads: int, head_dim: int,
                  dtype, device) -> Params:
    """Per-layer cache.  Native: {"k", "v"} [B, S, KVH, D] of `dtype`.
    `dtype=torch.int8`: int8 codes "k", "v" and fp32 per-(token, head)
    absmax scales "k_scale", "v_scale" [B, S, KVH, 1]."""
    shape = (batch, max_len, n_kv_heads, head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        sshape = (batch, max_len, n_kv_heads, 1)
        cache["k_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
        cache["v_scale"] = torch.zeros(sshape, dtype=torch.float32,
                                       device=device)
    return cache


def _quantize_kv(x: Tensor) -> Tuple[Tensor, Tensor]:
    """[..., D] -> (int8 codes, fp32 absmax scale [..., 1]): the
    reference's arithmetic step for step (fp32 division, round half to
    even, scale floored at 1e-8), so the codes are the same bits."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    codes = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return codes, scale


def _dequantize_kv(codes: Tensor, scale: Tensor, dtype) -> Tensor:
    return (codes.float() * scale).to(dtype)


def _cache_entries(cache: Params, k: Tensor, v: Tensor) -> Params:
    """What writing k/v [B, S, KVH, D] puts in `cache`'s leaves: k/v cast
    to the cache's dtype, or for an int8 cache their codes and scales."""
    if "k_scale" in cache:
        (k8, ks), (v8, vs) = _quantize_kv(k), _quantize_kv(v)
        return {"k": k8, "v": v8, "k_scale": ks, "v_scale": vs}
    return {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}


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


def as_pos(pos, device) -> Tensor:
    """A decode position (an int, or a 0-d integer tensor) as a 0-d int64
    tensor on `device`.  A tensor already there is returned as it is, so a
    captured decode step reads the position from device memory at every
    replay and nothing in the step depends on its value on the host."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64)
    return torch.full((), pos, dtype=torch.int64, device=device)


def cached_attention(params: Params, spec: AttnSpec, x: Tensor,
                     cache: Params, pos, ring: bool = False,
                     pad_mask: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Params]:
    """Decode-step attention: x [B,1,D], cache k/v [B,S,KVH,HD], pos (the
    current token's global position: an int or a 0-d integer tensor on
    x's device, as the reference's traced `start_pos + i`).  The new K/V
    are written into the cache in place, at `pos`, or with `ring=True` at
    slot `pos % S` of a ring buffer of S == sliding_window slots (RoPE is
    applied before the write, so positions stay global); an int8 cache
    takes their codes and scales there and is read dequantized.
    `pad_mask` ([B, P] bool, True = real) invalidates left-pad prompt
    slots; positions >= P are always valid.  Returns (attn output
    [B,1,D], cache).

    Everything that reads `pos` is device arithmetic: the slot is written
    with `index_copy_` at a one-element device index (indexing with a 0-d
    tensor would read it on the host), so the step makes no host sync.

    With `attn_impl == "flash"` on a plain causal layer (no ring, no
    sliding window, no softcap) the attention runs through the
    decode-attention kernel over the window [kv_start, pos + 1); otherwise
    the naive masked softmax below, as in the reference."""
    b = x.shape[0]
    s_cache = cache["k"].shape[1]
    pos = as_pos(pos, x.device)
    q, k_new, v_new = _project_qkv(params, spec, x, pos.expand(b, 1))
    slot = (torch.remainder(pos, s_cache) if ring else pos).reshape(1)
    for name, new in _cache_entries(cache, k_new, v_new).items():
        cache[name].index_copy_(1, slot, new)
    if "k_scale" in cache:
        # The reference's int8 read: the whole cache dequantized a step.
        k = _dequantize_kv(cache["k"], cache["k_scale"], k_new.dtype)
        v = _dequantize_kv(cache["v"], cache["v_scale"], v_new.dtype)
    else:
        k, v = cache["k"], cache["v"]

    # The reference's kernel route (`common.py:344-345`).
    if (spec.attn_impl == "flash" and not ring and spec.sliding_window == 0
            and spec.logit_softcap == 0.0):
        kv_start = None if pad_mask is None else kv_start_of(pad_mask)
        ctx = decode_attention(q[:, 0], k, v, pos + 1, kv_start,
                               scale=spec.query_scale)
        return attn_out(params, spec, ctx.reshape(b, 1, -1)), cache

    idx = torch.arange(s_cache, device=x.device)
    if ring:
        # Slot i holds global position pos - ((pos - i) mod S); it is valid
        # iff that position is inside the window and not negative.
        kpos = pos - torch.remainder(pos - idx, s_cache)
        mask = kpos >= (pos - s_cache + 1).clamp_min(0)
    else:
        kpos = idx
        mask = idx <= pos
        if spec.sliding_window > 0:
            mask = mask & (idx > pos - spec.sliding_window)
    mask = mask[None, None, :]
    if pad_mask is not None:
        mask = mask & _pad_valid_at(pad_mask, kpos)[:, None, :]
    ctx = mha_attend(q, k, v, mask.expand(b, 1, s_cache), spec)
    return attn_out(params, spec, ctx), cache


def prefill_into_cache(params: Params, spec: AttnSpec, x: Tensor,
                       cache: Params, ring: bool = False,
                       pad_mask: Optional[Tensor] = None,
                       pos_offset: Optional[int] = None,
                       prefix_len: int = 0) -> Tuple[Tensor, Params]:
    """Prefill: write S prompt tokens into the cache (in place, at
    `pos_offset`), return the attention output [B, S, D].  `pad_mask`
    ([B, S] bool, True = real token) masks left-pad slots out of the keys
    so ragged batches match their unpadded logits.  `prefix_len` slots at
    the front of the sequence (prefix embeddings, always valid) may sit
    before the pads: the kernel route then takes each row's valid keys as
    [0, prefix_len) and [prefix_len + pads, S).  `pos_offset` shifts
    the prompt to global positions [pos_offset, pos_offset + S) for RoPE
    and the cache write; attention itself is over the prompt alone, so the
    attention's query offset stays 0.

    A ring cache (`ring=True`, S_cache == sliding_window) keeps the last
    `window` tokens, token g in slot g % window.  A prompt of S >= window
    overwrites the whole ring; a shorter one at an offset is written at 0
    and the row rolled by `pos_offset % window`, which, as in the
    reference, assumes a fresh (all-zero) cache row.  An int8 cache takes
    the codes and scales of the same entries."""
    b, s, _ = x.shape
    s_cache = cache["k"].shape[1]
    off = 0 if pos_offset is None else int(pos_offset)
    positions = torch.arange(s, device=x.device)[None].expand(b, s) + off
    q, k, v = _project_qkv(params, spec, x, positions)
    if ring and s >= s_cache:
        w = s_cache
        start = (off + s - w) % w
        for name, new in _cache_entries(cache, k[:, s - w:],
                                        v[:, s - w:]).items():
            cache[name].copy_(torch.roll(new, start, dims=1))
    elif ring and pos_offset is not None:
        for name, new in _cache_entries(cache, k, v).items():
            cache[name][:, :s] = new
            cache[name].copy_(torch.roll(cache[name], off % s_cache, dims=1))
    else:
        for name, new in _cache_entries(cache, k, v).items():
            cache[name][:, off:off + s] = new
    if spec.attn_impl == "flash":
        kv_start = prefix = None
        if pad_mask is not None:
            # The prefix slots of the mask are True, so the pad count is
            # the count of False.
            kv_start = kv_start_of(pad_mask) + prefix_len
            if prefix_len:
                prefix = torch.full((b,), prefix_len, dtype=torch.int32,
                                    device=x.device)
        ctx = flash_attention(q, k, v, scale=spec.query_scale, causal=True,
                              window=spec.sliding_window,
                              softcap=spec.logit_softcap, kv_start=kv_start,
                              prefix_len=prefix)
        if pad_mask is not None and not prefix_len:
            # A left-pad query row has no valid key: the kernel writes 0,
            # the reference (naive and models/flash.py alike) the mean of
            # the S values.  Attention never reads such a row, but an MoE
            # FFN routes it and it takes expert capacity, so the port
            # gives it the reference's value.  (Behind a prefix every row
            # sees the prefix's keys, as in the reference.)
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

ACTS = {"silu": F.silu,
        # jax.nn.gelu's default is the tanh approximation: "gelu" (the
        # dense MLP's default) and "gelu_tanh" are one function there.
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu}


def gated_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                   device, use_bias: bool = False) -> Params:
    p = {"w_gate": dense_init(gen, d_model, d_ff, dtype, device),
         "w_up": dense_init(gen, d_model, d_ff, dtype, device),
         "w_down": dense_init(gen, d_ff, d_model, dtype, device)}
    if use_bias:
        p["b_gate"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_up"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_down"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def gated_mlp(params: Params, x: Tensor, act: str = "silu") -> Tensor:
    """SwiGLU (`act="silu"`) or GeGLU (`act="gelu_tanh"`)."""
    g, u = x @ params["w_gate"], x @ params["w_up"]
    if "b_gate" in params:
        g, u = g + params["b_gate"], u + params["b_up"]
    out = (ACTS[act](g) * u) @ params["w_down"]
    if "b_down" in params:
        out = out + params["b_down"]
    return out


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype, device,
             use_bias: bool = True) -> Params:
    p = {"w_in": dense_init(gen, d_model, d_ff, dtype, device),
         "w_out": dense_init(gen, d_ff, d_model, dtype, device)}
    if use_bias:
        p["b_in"] = torch.zeros((d_ff,), dtype=dtype, device=device)
        p["b_out"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def mlp(params: Params, x: Tensor, act: str = "gelu") -> Tensor:
    """The dense (non-gated) MLP, with biases where params hold them
    (starcoder2)."""
    h = x @ params["w_in"]
    if "b_in" in params:
        h = h + params["b_in"]
    out = ACTS[act](h) @ params["w_out"]
    if "b_out" in params:
        out = out + params["b_out"]
    return out


def embed(params: Params, tokens: Tensor, scale_by_sqrt_dim: bool = False
          ) -> Tensor:
    x = params["embedding"][tokens]
    if scale_by_sqrt_dim:
        x = x * _sqrt_dim(x.shape[-1], x.dtype)
    return x


@functools.lru_cache(maxsize=None)
def _sqrt_dim(d: int, dtype: torch.dtype) -> float:
    """sqrt(d) rounded to `dtype`, as the reference's scale tensor is, held
    as a Python float: the product of two values of `dtype` is exact in
    fp32 and rounded once, as the reference's is, with no device copy."""
    return float(torch.tensor(math.sqrt(d), dtype=dtype))


def unembed(params: Params, x: Tensor, tied: bool = True,
            final_softcap: float = 0.0) -> Tensor:
    """Unembedding through the embedding table (tied) or `lm_head` (both
    [V, D]); logits in fp32, softcapped as `c * tanh(logits / c)` where
    `final_softcap` c > 0 (gemma2)."""
    table = params["embedding"] if tied else params["lm_head"]
    logits = (x @ table.T).float()
    if final_softcap > 0.0:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    return logits


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


# ---------------------------------------------------------------------------
# Weights from JAX
# ---------------------------------------------------------------------------

def tensor_from_jax(a, dtype, device) -> Tensor:
    """A numpy or JAX array as a torch tensor of `dtype` on `device`."""
    # np.asarray of a bf16 JAX array is an ml_dtypes.bfloat16 array, which
    # torch.from_numpy rejects; float32 holds every bf16 value exactly.
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()) \
        .to(device=device, dtype=dtype)


def params_from_jax_tree(tree: Params, stacks: Dict[str, int],
                         dtype_of: Callable[[str], Any], device) -> Params:
    """The port's params from a JAX params tree (nested dicts of numpy or
    JAX arrays) in which each key of `stacks` (`{"layers": n_layers}`, or
    the encoder-decoder's two stacks) holds that many layers stacked on a
    leading `[layers, ...]` axis.  Keys are kept, each stack is unstacked
    into a list of per-layer dicts, weights keep their layout, and each
    leaf is cast to `dtype_of(its key)`."""

    def conv(node, layer=None, key=None):
        if isinstance(node, dict):
            return {k: conv(v, layer, k) for k, v in node.items()}
        a = np.asarray(node, dtype=np.float32)
        return tensor_from_jax(a if layer is None else a[layer],
                               dtype_of(key), device)

    out = {k: conv(v) for k, v in tree.items() if k not in stacks}
    for name, n_layers in stacks.items():
        leaf = tree[name]
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        n = np.asarray(leaf).shape[0]
        if n != n_layers:
            raise ValueError(f"tree has {n} {name}, config {n_layers}")
        out[name] = [conv(tree[name], i) for i in range(n)]
    return out
