"""RecurrentGemma / Griffin (arXiv:2402.19427) of the port:
`repro.models.rglru`, RG-LRU recurrent blocks interleaved 2:1 with local
(sliding-window MQA) attention, for inference.

Block pattern: (recurrent, recurrent, attention) repeating; every temporal
block is followed by a GeGLU MLP block.

Recurrent block:
    x -> norm -> [ branch_a: W_x -> conv1d(k=4, causal, depthwise) -> RG-LRU
                   branch_b: W_gate -> GeLU (tanh form) ]
      -> a * b -> W_out -> residual

RG-LRU (per channel):
    r_t = sigmoid(W_a y_t + b_a),  i_t = sigmoid(W_i y_t + b_i)
    log a_t = -8 softplus(lambda) r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t y_t)
Every recurrence (the prompt's scan and every decode step) goes through
`kernels/rglru/ops.rglru_gated` with the two gate products W_a y and W_i y
(cuBLAS, as the reference's einsums): the gate arithmetic and the
recurrence in one hand-written CUDA kernel on the card, their plain
versions on the CPU.  The reference runs `jax.lax.associative_scan` and a
one-token step there, never its Pallas kernel.

Public API (used by serving/ and the tests):
    init_params(cfg, seed, device)          -> params
    params_from_jax(cfg, tree, device)      -> params from JAX's params tree
    cache_from_jax(cfg, tree, device)       -> cache from JAX's cache tree
    forward(cfg, params, tokens)            -> (logits, aux = 0)
    init_cache(cfg, batch, max_len, device) -> zero state + KV caches
    prefill(cfg, params, tokens, cache)     -> (last logits, cache)
    decode_step(cfg, params, token, cache, pos) -> (logits, cache)

Params keep the reference's keys and `[in, out]` weight layout; the
reference stacks `rec_blocks`, `attn_blocks` and `mlps` on three leading
axes, here they are lists of per-block dicts, and `norms_temporal` /
`norms_mlp` stay `{"scale": [n_layers, d]}`.  The cache keeps the
reference's stacked layout, `{"conv_tail": [R, B, 3, W], "lru_h": [R, B,
W] fp32, "attn": {"k", "v": [A, B, L, KVH, D]}}` with L = min(max_len,
window) (a ring buffer when L == window), and `prefill` / `decode_step`
update it in place.  A caller that reuses a cache zeroes the recurrent
part (`STATE_KEYS`) before the next prompt, as the serving engine does.

Training (`loss_fn`, remat) and prefix embeddings are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.rglru.ops import rglru_gated, rglru_gates_ref
from repro_torch.kernels.rglru.ref import LRU_C
from repro_torch.models import common, flash
from repro_torch.models.common import AttnSpec

Params = Dict[str, Any]
Tensor = torch.Tensor

_CONV_K = 4

#: The recurrent part of the cache, which prefill reads whole: a reused
#: cache zeroes these before a new prompt (the ring KV part needs no
#: reset: every slot a call reads was written by it or is masked).
STATE_KEYS = ("conv_tail", "lru_h")

#: Leaves kept in fp32 whatever `cfg.dtype` is, as in the reference.
_FP32_LEAVES = frozenset({"lru_lambda", "b_a", "b_i"})


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    name: str
    n_layers: int                  # total temporal blocks (38 for 9b)
    d_model: int
    n_heads: int                   # local-attn query heads
    n_kv_heads: int                # 1 (MQA)
    head_dim: int
    d_ff: int
    vocab_size: int
    lru_width: Optional[int] = None   # default d_model
    sliding_window: int = 2048
    pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")
    rope_theta: float = 10000.0
    attn_impl: str = "naive"
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = True
    remat: str = "none"
    max_seq_len: int = 1 << 20

    def __post_init__(self):
        if self.remat != "none":
            raise ValueError(f"the port has no remat={self.remat!r} path "
                             "(training is not ported); only 'none'")
        if self.attn_impl not in ("naive", "flash"):
            raise ValueError(f"attn_impl must be 'naive' or 'flash', got "
                             f"{self.attn_impl!r}")

    @property
    def width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def block_types(self) -> Tuple[str, ...]:
        return tuple(self.pattern[i % len(self.pattern)]
                     for i in range(self.n_layers))

    @property
    def n_recurrent(self) -> int:
        return sum(t == "recurrent" for t in self.block_types)

    def attn_spec(self) -> AttnSpec:
        return AttnSpec(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.head_dim,
            rope_theta=self.rope_theta,
            sliding_window=self.sliding_window, attn_impl=self.attn_impl)

    @property
    def n_params(self) -> int:
        d, w, f, v = self.d_model, self.width, self.d_ff, self.vocab_size
        h, kvh, hd = self.n_heads, self.n_kv_heads, self.head_dim
        rec = 3 * d * w + 2 * w * w + (_CONV_K + 4) * w  # proj + gates + conv
        attn = d * h * hd + 2 * d * kvh * hd + h * hd * d
        mlp = 3 * d * f
        n_rec = self.n_recurrent
        n_att = self.n_layers - n_rec
        per_mlp = self.n_layers * (mlp + 2 * d)
        return (n_rec * (rec + d) + n_att * (attn + d) + per_mlp
                + v * d * (1 if self.tie_embeddings else 2))

    @property
    def n_active_params(self) -> int:
        return self.n_params


# ---------------------------------------------------------------------------
# Init and weights from JAX
# ---------------------------------------------------------------------------

def _rec_block_init(cfg: RGLRUConfig, gen: torch.Generator, dev) -> Params:
    d, w, dt = cfg.d_model, cfg.width, cfg.dtype
    u = torch.empty((w,), dtype=torch.float32, device=dev).uniform_(
        0.9, 0.999, generator=gen)
    return {
        "w_x": common.dense_init(gen, d, w, dt, dev),
        "w_gate": common.dense_init(gen, d, w, dt, dev),
        "conv_w": (0.1 * torch.randn((_CONV_K, w), generator=gen,
                                     dtype=torch.float32, device=dev)
                   ).to(dt),
        "conv_b": torch.zeros((w,), dtype=dt, device=dev),
        # softplus^-1 of the target decay strengths.
        "lru_lambda": torch.log(torch.expm1(-torch.log(u) / LRU_C)),
        "w_a": common.dense_init(gen, w, w, dt, dev, scale=0.01),
        "b_a": torch.zeros((w,), dtype=torch.float32, device=dev),
        "w_i": common.dense_init(gen, w, w, dt, dev, scale=0.01),
        "b_i": torch.zeros((w,), dtype=torch.float32, device=dev),
        "w_out": common.dense_init(gen, w, d, dt, dev),
    }


def init_params(cfg: RGLRUConfig, seed: int = 0, device=None) -> Params:
    """Random weights from a torch generator seeded with `seed`, made on
    `device` (CUDA unless told otherwise), with the reference's shapes,
    scales and zero-initialised biases and norm scales."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    spec, d, dt = cfg.attn_spec(), cfg.d_model, cfg.dtype
    rec, att = [], []
    for t in cfg.block_types:
        if t == "recurrent":
            rec.append(_rec_block_init(cfg, gen, dev))
        else:
            att.append({"attn": common.attn_init(gen, spec, dt, dev)})
    return {
        "embedding": common.embed_init(gen, cfg.vocab_size, d, dt, dev),
        "rec_blocks": rec,
        "attn_blocks": att,
        "mlps": [common.gated_mlp_init(gen, d, cfg.d_ff, dt, dev)
                 for _ in range(cfg.n_layers)],
        "norms_temporal": {"scale": torch.zeros((cfg.n_layers, d), dtype=dt,
                                                device=dev)},
        "norms_mlp": {"scale": torch.zeros((cfg.n_layers, d), dtype=dt,
                                           device=dev)},
        "final_norm": common.rmsnorm_init(d, dt, dev),
    }


def params_from_jax(cfg: RGLRUConfig, tree: Params, device=None) -> Params:
    """The port's params from the JAX params tree of the same config: the
    three stacked groups unstacked into lists, every other leaf as it is;
    `lru_lambda`, `b_a` and `b_i` in fp32, the rest in `cfg.dtype`."""
    dev = resolve_device(device)

    def conv(node, index=None, key=None):
        if isinstance(node, dict):
            return {k: conv(v, index, k) for k, v in node.items()}
        a = np.asarray(node, dtype=np.float32)
        dt = torch.float32 if key in _FP32_LEAVES else cfg.dtype
        return common.tensor_from_jax(a if index is None else a[index], dt,
                                      dev)

    n_rec = cfg.n_recurrent
    sizes = {"rec_blocks": n_rec, "attn_blocks": cfg.n_layers - n_rec,
             "mlps": cfg.n_layers}
    out = {}
    for key, node in tree.items():
        if key not in sizes:
            out[key] = conv(node)
            continue
        n = sizes[key]
        leaf = node
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        stacked = np.asarray(leaf).shape[0]
        if stacked != n:
            raise ValueError(f"tree's {key} stacks {stacked} blocks, config "
                             f"{n}")
        out[key] = [conv(node, i) for i in range(n)]
    return out


def cache_from_jax(cfg: RGLRUConfig, tree: Params, device=None) -> Params:
    """The port's cache from the reference's cache tree (the stacked
    layouts are the same): `lru_h` in fp32, the rest in `cfg.dtype`."""
    dev = resolve_device(device)
    return {"conv_tail": common.tensor_from_jax(tree["conv_tail"], cfg.dtype,
                                                dev),
            "lru_h": common.tensor_from_jax(tree["lru_h"], torch.float32,
                                            dev),
            "attn": {k: common.tensor_from_jax(tree["attn"][k], cfg.dtype,
                                               dev) for k in ("k", "v")}}


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------

def _gate_inputs(bp: Params, y: Tensor):
    """The gate products (in the weight dtype), y and the fp32 [W] gate
    vectors, in `rglru_gated`'s argument order."""
    return (y @ bp["w_a"], y @ bp["w_i"], y, bp["b_a"], bp["b_i"],
            bp["lru_lambda"])


def _rglru_gates(bp: Params, y: Tensor) -> Tuple[Tensor, Tensor]:
    """log_a [B,S,W] fp32, gated input [B,S,W] fp32.  The products run in
    the weight dtype, the gates in fp32."""
    return rglru_gates_ref(*_gate_inputs(bp, y))


def rglru_scan(bp: Params, y: Tensor, h0: Tensor) -> Tuple[Tensor, Tensor]:
    """h_t = a_t h_{t-1} + b_t over y [B,S,W] from h0 [B,W] fp32, which is
    overwritten with h_last in place, the gates made inside the same call
    (`rglru_gated`).  Returns (h [B,S,W] fp32, h0).  The one-token step
    (the reference's `rglru_step`) is the same call at S == 1."""
    return rglru_gated(*_gate_inputs(bp, y), h0)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _causal_conv(bp: Params, y: Tensor, tail: Tensor) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv1d k=4.  y: [B,S,W]; tail: [B,3,W] carries the
    previous samples.  The taps are summed in y's dtype in the reference's
    order.  Returns (out, new tail)."""
    s = y.shape[1]
    ytail = torch.cat([tail.to(y.dtype), y], dim=1)
    w = bp["conv_w"].to(y.dtype)          # [K, W]
    out = ytail[:, 0:s] * w[_CONV_K - 1]
    for i in range(1, _CONV_K):
        out = out + ytail[:, i:i + s] * w[_CONV_K - 1 - i]
    out = out + bp["conv_b"].to(y.dtype)
    return out, ytail[:, -(_CONV_K - 1):]


def _recurrent_block(bp: Params, x: Tensor, conv_tail: Tensor,
                     lru_h: Tensor) -> Tensor:
    """x: [B,S,D] (already normed); conv_tail [B,3,W] and lru_h [B,W] are
    updated in place.  Returns the block's output."""
    ya = x @ bp["w_x"]
    yb = common.ACTS["gelu_tanh"](x @ bp["w_gate"])
    ya, new_tail = _causal_conv(bp, ya, conv_tail)
    conv_tail.copy_(new_tail)
    h, _ = rglru_scan(bp, ya, lru_h)
    return (h.to(x.dtype) * yb) @ bp["w_out"]


def _self_attention(params: Params, spec: AttnSpec, x: Tensor) -> Tensor:
    """Full-sequence windowed self-attention without a cache (forward)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q, k, v = common._project_qkv(params, spec, x, positions)
    if spec.attn_impl == "flash":
        ctx = flash.flash_attention(q, k, v, spec, causal=True)
    else:
        mask = common.causal_mask(s, s, window=spec.sliding_window,
                                  device=x.device)
        ctx = common.mha_attend(q, k, v, mask.expand(b, s, s), spec)
    return common.attn_out(params, spec, ctx)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def init_cache(cfg: RGLRUConfig, batch: int, max_len: int,
               device=None) -> Params:
    """Zero recurrent state and attention caches of min(max_len, window)
    slots, stacked over their blocks."""
    dev = resolve_device(device)
    n_rec = cfg.n_recurrent
    n_att = cfg.n_layers - n_rec
    kv = (n_att, batch, min(max_len, cfg.sliding_window), cfg.n_kv_heads,
          cfg.head_dim)
    return {
        "conv_tail": torch.zeros((n_rec, batch, _CONV_K - 1, cfg.width),
                                 dtype=cfg.dtype, device=dev),
        "lru_h": torch.zeros((n_rec, batch, cfg.width), dtype=torch.float32,
                             device=dev),
        "attn": {"k": torch.zeros(kv, dtype=cfg.dtype, device=dev),
                 "v": torch.zeros(kv, dtype=cfg.dtype, device=dev)},
    }


def _run(cfg: RGLRUConfig, params: Params, x: Tensor,
         cache: Optional[Params], pos: Optional[Tensor], mode: str,
         pad_mask: Optional[Tensor] = None,
         pos_offset: Optional[int] = None) -> Tensor:
    """mode: 'train' (no cache IO; the recurrent state starts from `cache`
    and is updated in it), 'prefill' (cache writes), 'decode' (one step).
    `pad_mask` / `pos_offset` reach only the attention blocks; the
    recurrent blocks fold every input token, pads included, as in the
    reference."""
    spec = cfg.attn_spec()
    ri = ai = 0
    for li, t in enumerate(cfg.block_types):
        h_in = common.rmsnorm({"scale": params["norms_temporal"]["scale"][li]},
                              x)
        if t == "recurrent":
            out = _recurrent_block(params["rec_blocks"][ri], h_in,
                                   cache["conv_tail"][ri],
                                   cache["lru_h"][ri])
            ri += 1
        else:
            ap = params["attn_blocks"][ai]["attn"]
            if mode == "train":
                out = _self_attention(ap, spec, h_in)
            else:
                c = {"k": cache["attn"]["k"][ai], "v": cache["attn"]["v"][ai]}
                ring = c["k"].shape[1] == cfg.sliding_window
                if mode == "prefill":
                    out, _ = common.prefill_into_cache(
                        ap, spec, h_in, c, ring=ring, pad_mask=pad_mask,
                        pos_offset=pos_offset)
                else:
                    out, _ = common.cached_attention(ap, spec, h_in, c, pos,
                                                     ring=ring,
                                                     pad_mask=pad_mask)
            ai += 1
        x = x + out
        h_in = common.rmsnorm({"scale": params["norms_mlp"]["scale"][li]}, x)
        x = x + common.gated_mlp(params["mlps"][li], h_in, act="gelu_tanh")
    return x


def forward(cfg: RGLRUConfig, params: Params, tokens: Tensor
            ) -> Tuple[Tensor, Tensor]:
    """tokens: [B, S] int.  Returns (logits [B, S, V] fp32, 0)."""
    x = common.embed(params, tokens, scale_by_sqrt_dim=True)
    cache = init_cache(cfg, x.shape[0], 1, x.device)
    x = _run(cfg, params, x, cache, None, "train")
    x = common.rmsnorm(params["final_norm"], x)
    logits = common.unembed(params, x, cfg.tie_embeddings)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(cfg: RGLRUConfig, params: Params, tokens: Tensor, cache: Params,
            attn_mask: Optional[Tensor] = None,
            pos_offset: Optional[int] = None) -> Tuple[Tensor, Params]:
    """Run the prompt into `cache` (updated in place).  `attn_mask` masks
    left-pad slots out of the attention blocks' keys and `pos_offset`
    places the prompt at global positions for them; the recurrent blocks
    fold every token into their state, so a left-padded prompt's logits
    depend on its padding, as in the reference.  Returns (logits for the
    last position [B, V], cache)."""
    x = common.embed(params, tokens, scale_by_sqrt_dim=True)
    x = _run(cfg, params, x, cache, None, "prefill", pad_mask=attn_mask,
             pos_offset=pos_offset)
    x = common.rmsnorm(params["final_norm"], x[:, -1:])
    logits = common.unembed(params, x, cfg.tie_embeddings)
    return logits[:, 0], cache


def decode_step(cfg: RGLRUConfig, params: Params, token: Tensor,
                cache: Params, pos, attn_mask: Optional[Tensor] = None
                ) -> Tuple[Tensor, Params]:
    """token: [B] int; pos: its global position, an int or a 0-d integer
    tensor on the device (`common.as_pos`).  `attn_mask` reaches the
    attention blocks only.  Returns (logits [B, V], cache updated in
    place)."""
    x = common.embed(params, token[:, None], scale_by_sqrt_dim=True)
    x = _run(cfg, params, x, cache, common.as_pos(pos, token.device),
             "decode", pad_mask=attn_mask)
    x = common.rmsnorm(params["final_norm"], x)
    logits = common.unembed(params, x, cfg.tie_embeddings)
    return logits[:, 0], cache

