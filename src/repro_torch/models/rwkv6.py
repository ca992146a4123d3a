"""RWKV-6 "Finch" (arXiv:2404.05892) of the port: `repro.models.rwkv6`, an
attention-free LM with data-dependent per-channel decay, for inference.

Time mixing (per head h, head dim N):
    S_t   = diag(w_t) . S_{t-1} + k_t v_t^T          (state: N x N)
    y_t   = r_t . (S_{t-1} + diag(u) k_t v_t^T)
with w_t = exp(logw_t), logw = -exp(logit - 2) clipped to [-4, -1e-6].
Every WKV recurrence (the prompt's whole chunks, its per-token tail and
every decode step) goes through `kernels/rwkv6/ops.wkv6`: the hand-written
CUDA kernel on the card, its plain version on the CPU.  The reference runs
its own pure-JAX `wkv6_chunked` and `wkv6_decode` there.

Public API (used by serving/ and the tests):
    init_params(cfg, seed, device)         -> params
    params_from_jax(cfg, tree, device)     -> params from JAX's params tree
    state_from_jax(cfg, tree, device)      -> state from JAX's state tree
    forward(cfg, params, tokens)           -> (logits, aux = 0)
    init_cache(cfg, batch, max_len, device) -> zero recurrent state
    prefill(cfg, params, tokens, cache)    -> (last logits, state)
    decode_step(cfg, params, token, cache, pos) -> (logits, state)

Params keep the reference's keys and `[in, out]` weight layout;
`params["layers"]` is a list of per-layer dicts (the reference stacks them
for `lax.scan`).  The state keeps the reference's stacked layout,
`{"tm_shift": [L, B, D], "cm_shift": [L, B, D], "wkv": [L, B, H, N, N]}`,
and `prefill` and `decode_step` update it in place instead of returning a
fresh copy (the WKV state of rwkv6-3b at batch 28 is 0.59 GB).  A caller
that reuses a state buffer zeroes it before the next prompt, as the
serving engine does.

Training (`loss_fn`, remat) and prefix embeddings are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.models import common

Params = Dict[str, Any]
Tensor = torch.Tensor

#: The recurrent state a reused cache zeroes before a new prompt: all of it.
STATE_KEYS = ("tm_shift", "cm_shift", "wkv")


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    name: str
    n_layers: int
    d_model: int
    head_dim: int          # N; n_heads = d_model // head_dim
    d_ff: int
    vocab_size: int
    lora_rank_decay: int = 64
    lora_rank_mix: int = 32
    chunk: int = 32
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    remat: str = "none"
    max_seq_len: int = 1 << 20   # state is O(1); no positional table

    def __post_init__(self):
        if self.remat != "none":
            raise ValueError(f"the port has no remat={self.remat!r} path "
                             "(training is not ported); only 'none'")

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim

    @property
    def n_params(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        rd, rm = self.lora_rank_decay, self.lora_rank_mix
        tm = (5 * d * d            # wr wk wv wg wo
              + 2 * d * 5 * rm     # maa LoRA
              + 2 * d * rd         # decay LoRA
              + d                  # bonus
              + 9 * d)             # maa vectors + decay_base + ln_x
        cm = 2 * d * f + d * d
        per_layer = tm + cm + 4 * d
        return self.n_layers * per_layer + v * d * (
            1 if self.tie_embeddings else 2)

    @property
    def n_active_params(self) -> int:
        return self.n_params


# ---------------------------------------------------------------------------
# Init and weights from JAX
# ---------------------------------------------------------------------------

def _small_normal(gen: torch.Generator, shape, dtype, device) -> Tensor:
    return (0.01 * torch.randn(shape, generator=gen, dtype=torch.float32,
                               device=device)).to(dtype)


def _time_mix_init(cfg: RWKV6Config, gen: torch.Generator, dev) -> Params:
    d, h, n, dt = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.dtype
    rm, rd = cfg.lora_rank_mix, cfg.lora_rank_decay

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)
    return {
        "maa_x": zeros(d),
        "maa_rkvwg": zeros(5, d),
        "maa_w1": common.dense_init(gen, d, 5 * rm, dt, dev),
        "maa_w2": _small_normal(gen, (5, rm, d), dt, dev),
        "decay_base": zeros(d),
        "decay_w1": common.dense_init(gen, d, rd, dt, dev),
        "decay_w2": _small_normal(gen, (rd, d), dt, dev),
        "bonus": zeros(h, n),
        **{w: common.dense_init(gen, d, d, dt, dev)
           for w in ("wr", "wk", "wv", "wg", "wo")},
        "ln_x": common.layernorm_init(d, dt, dev),
    }


def _channel_mix_init(cfg: RWKV6Config, gen: torch.Generator, dev
                      ) -> Params:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.dtype
    return {
        "maa_k": torch.zeros((d,), dtype=dt, device=dev),
        "maa_r": torch.zeros((d,), dtype=dt, device=dev),
        "wk": common.dense_init(gen, d, f, dt, dev),
        "wv": common.dense_init(gen, f, d, dt, dev),
        "wr": common.dense_init(gen, d, d, dt, dev),
    }


def init_params(cfg: RWKV6Config, seed: int = 0, device=None) -> Params:
    """Random weights from a torch generator seeded with `seed`, made on
    `device` (CUDA unless told otherwise), with the reference's shapes,
    scales and zero-initialised mixes, decay base and bonus."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers = [{"ln1": common.layernorm_init(cfg.d_model, cfg.dtype, dev),
               "ln2": common.layernorm_init(cfg.d_model, cfg.dtype, dev),
               "time_mix": _time_mix_init(cfg, gen, dev),
               "channel_mix": _channel_mix_init(cfg, gen, dev)}
              for _ in range(cfg.n_layers)]
    params = {"embedding": common.embed_init(gen, cfg.vocab_size,
                                             cfg.d_model, cfg.dtype, dev),
              "ln0": common.layernorm_init(cfg.d_model, cfg.dtype, dev),
              "layers": layers,
              "final_norm": common.layernorm_init(cfg.d_model, cfg.dtype,
                                                  dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = common.embed_init(gen, cfg.vocab_size,
                                              cfg.d_model, cfg.dtype, dev)
    return params


def params_from_jax(cfg: RWKV6Config, tree: Params, device=None) -> Params:
    """The port's params from the JAX params tree of the same config
    (`common.params_from_jax_tree`), every leaf in `cfg.dtype`."""
    return common.params_from_jax_tree(tree, {"layers": cfg.n_layers},
                                       lambda key: cfg.dtype,
                                       resolve_device(device))


def state_from_jax(cfg: RWKV6Config, tree: Params, device=None) -> Params:
    """The port's state from the reference's state tree (stacked layouts
    are the same): shifts in `cfg.dtype`, the WKV state in fp32."""
    dev = resolve_device(device)
    return {"tm_shift": common.tensor_from_jax(tree["tm_shift"], cfg.dtype,
                                               dev),
            "cm_shift": common.tensor_from_jax(tree["cm_shift"], cfg.dtype,
                                               dev),
            "wkv": common.tensor_from_jax(tree["wkv"], torch.float32, dev)}


# ---------------------------------------------------------------------------
# Time and channel mixing
# ---------------------------------------------------------------------------

def _token_shift(x: Tensor, shift_state: Tensor) -> Tensor:
    """sx = previous token's input - x, with `shift_state` ([B, D]) before
    the first token."""
    return torch.cat([shift_state[:, None], x[:, :-1]], dim=1) - x


def _ddlerp(tm: Params, x: Tensor, sx: Tensor) -> Tuple[Tensor, ...]:
    """Data-dependent lerps for (r, k, v, w, g).  x, sx: [B, S, D]."""
    xx = x + sx * tm["maa_x"]
    lora = torch.tanh(xx @ tm["maa_w1"])
    b, s, _ = x.shape
    rm = tm["maa_w2"].shape[1]
    lora = lora.reshape(b, s, 5, rm)
    deltas = torch.einsum("bskr,krd->kbsd", lora, tm["maa_w2"])
    return tuple(x + sx * (tm["maa_rkvwg"][i] + deltas[i])
                 for i in range(5))   # xr, xk, xv, xw, xg


def _rkvwg(tm: Params, cfg: RWKV6Config, x: Tensor, sx: Tensor):
    xr, xk, xv, xw, xg = _ddlerp(tm, x, sx)
    b, s, _ = x.shape
    h, n = cfg.n_heads, cfg.head_dim
    r = (xr @ tm["wr"]).reshape(b, s, h, n)
    k = (xk @ tm["wk"]).reshape(b, s, h, n)
    v = (xv @ tm["wv"]).reshape(b, s, h, n)
    g = F.silu(xg @ tm["wg"])
    # log-decay (negative): w = exp(-exp(logit)) in (0, 1).
    lora_w = torch.tanh((xw @ tm["decay_w1"]).float())
    logit = tm["decay_base"].float() + lora_w @ tm["decay_w2"].float()
    logw = -torch.exp(logit - 2.0)          # init bias toward slow decay
    # The reference's clamp for the chunked form's fp32 exponent budget.
    logw = torch.clamp(logw, -4.0, -1e-6)
    return r, k, v, logw.reshape(b, s, h, n), g


def _time_mix(tm: Params, cfg: RWKV6Config, x: Tensor, shift_state: Tensor,
              wkv_state: Tensor, chunked: bool) -> Tensor:
    """x: [B, S, D]; shift_state [B, D] and wkv_state [B, H, N, N] are
    updated in place.  Returns the block's output."""
    b, s, d = x.shape
    r, k, v, logw, g = _rkvwg(tm, cfg, x, _token_shift(x, shift_state))
    y, _ = wkv6(r, k, v, logw, tm["bonus"].float(), wkv_state,
                chunk=min(cfg.chunk, s) if chunked else 1)
    shift_state.copy_(x[:, -1])
    y = y.reshape(b, s, d).to(x.dtype)
    # LayerNorm over the full d_model, as the reference's ln_x (not a
    # per-head GroupNorm).
    y = common.layernorm(tm["ln_x"], y)
    y = y * g.reshape(b, s, d).to(y.dtype)
    return y @ tm["wo"]


def _channel_mix(cm: Params, x: Tensor, shift_state: Tensor) -> Tensor:
    """x: [B, S, D]; shift_state [B, D] is updated in place."""
    sx = _token_shift(x, shift_state)
    shift_state.copy_(x[:, -1])
    xk = x + sx * cm["maa_k"]
    xr = x + sx * cm["maa_r"]
    k = torch.square(torch.relu(xk @ cm["wk"]))
    return torch.sigmoid(xr @ cm["wr"]) * (k @ cm["wv"])


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def init_state(cfg: RWKV6Config, batch: int, device=None) -> Params:
    """Zero recurrent state, stacked over layers (the 'cache')."""
    dev = resolve_device(device)
    h, n = cfg.n_heads, cfg.head_dim
    shift = (cfg.n_layers, batch, cfg.d_model)
    return {"tm_shift": torch.zeros(shift, dtype=cfg.dtype, device=dev),
            "cm_shift": torch.zeros(shift, dtype=cfg.dtype, device=dev),
            "wkv": torch.zeros((cfg.n_layers, batch, h, n, n),
                               dtype=torch.float32, device=dev)}


def init_cache(cfg: RWKV6Config, batch: int, max_len: int,
               device=None) -> Params:
    """The engines' name for the state; its size does not depend on
    `max_len`."""
    del max_len
    return init_state(cfg, batch, device)


def _run(cfg: RWKV6Config, params: Params, x: Tensor, state: Params,
         chunked: bool) -> Tensor:
    for i, lp in enumerate(params["layers"]):
        h = common.layernorm(lp["ln1"], x)
        x = x + _time_mix(lp["time_mix"], cfg, h, state["tm_shift"][i],
                          state["wkv"][i], chunked)
        h = common.layernorm(lp["ln2"], x)
        x = x + _channel_mix(lp["channel_mix"], h, state["cm_shift"][i])
    return x


def forward(cfg: RWKV6Config, params: Params, tokens: Tensor
            ) -> Tuple[Tensor, Tensor]:
    """tokens: [B, S] int.  Returns (logits [B, S, V] fp32, 0): the whole
    sequence in chunked form from a zero state, right-padded to a chunk
    multiple as the reference does (the recurrence is causal, so padded
    steps cannot reach real positions)."""
    x = common.layernorm(params["ln0"], common.embed(params, tokens))
    b, s, d = x.shape
    pad = (-s) % cfg.chunk
    if pad:
        x = torch.cat([x, x.new_zeros((b, pad, d))], dim=1)
    x = _run(cfg, params, x, init_state(cfg, b, x.device), chunked=True)
    x = common.layernorm(params["final_norm"], x[:, :s])
    logits = common.unembed(params, x, cfg.tie_embeddings)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(cfg: RWKV6Config, params: Params, tokens: Tensor, cache: Params,
            attn_mask: Optional[Tensor] = None,
            pos_offset: Optional[int] = None) -> Tuple[Tensor, Params]:
    """Run the prompt into the state `cache` (updated in place) with the
    reference's split: its whole chunks in one chunked pass, the rest one
    token at a time.  `attn_mask` and `pos_offset` are accepted for the
    engine's API and unused, as in the reference: the state is
    position-free, and left-pad tokens are folded into it like any other
    token.  Returns (logits for the last position [B, V], cache)."""
    del attn_mask, pos_offset
    x = common.layernorm(params["ln0"], common.embed(params, tokens))
    head = (x.shape[1] // cfg.chunk) * cfg.chunk
    last = None
    if head:
        last = _run(cfg, params, x[:, :head], cache, chunked=True)[:, -1:]
    for i in range(head, x.shape[1]):
        last = _run(cfg, params, x[:, i:i + 1], cache, chunked=False)
    x = common.layernorm(params["final_norm"], last)
    logits = common.unembed(params, x, cfg.tie_embeddings)
    return logits[:, 0], cache


def decode_step(cfg: RWKV6Config, params: Params, token: Tensor,
                cache: Params, pos, attn_mask: Optional[Tensor] = None
                ) -> Tuple[Tensor, Params]:
    """token: [B] int.  `pos` (an int or a 0-d device tensor) and
    `attn_mask` are unused (the state is position-free).  Returns (logits
    [B, V], cache updated in place)."""
    del pos, attn_mask
    x = common.layernorm(params["ln0"], common.embed(params, token[:, None]))
    x = _run(cfg, params, x, cache, chunked=False)
    x = common.layernorm(params["final_norm"], x)
    logits = common.unembed(params, x, cfg.tie_embeddings)
    return logits[:, 0], cache
