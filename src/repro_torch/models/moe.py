"""Token-choice top-k Mixture-of-Experts FFN of the port (OLMoE style), the
counterpart of `repro.models.moe`.

Tokens are grouped by expert into a fixed per-expert capacity (GShard
style: a (token, k) pair past its expert's capacity is dropped and the
token keeps only the residual), and all three expert products run through
the grouped GEMM kernel (`kernels/moe_gemm/ops.py`).

  1. router softmax in fp32, top-k experts per token, renormalised
  2. stable sort of the (token, k) pairs by expert id
  3. dispatch into an expert-major buffer `[E, R * C, D]`
  4. grouped expert GEMMs (gate, up, down)
  5. combine: each token gathers its k outputs, scaled by their weights

`moe_apply` dispatches per batch row for S > 1 (R = B rows of S tokens,
C = capacity(S)) and `_moe_apply_flat` over the whole batch for S == 1
(R = 1 row of B tokens, C = capacity(B)), as the reference does.  Left-pad
tokens are routed too and take capacity, as in the reference.

Layout: the reference's per-row buffer is `[B, E, C, D]`; here row r's
slot of expert e is `e * R * C + r * C + pos`, so one `grouped_gemm`
launch covers the batch without a transpose copy.  The arithmetic is the
reference's.  Dispatch is an indexed assignment (each valid slot receives
one pair; dropped pairs go to a spare row past the buffer) and the combine
sums each token's k pairs in a fixed order, so no step uses atomics and
bf16 results do not vary from run to run.

The reference's `autoshard` constraints are no-ops without a device mesh,
and the port runs on one device, so they are left out, and with them
`MoEConfig.shard_mode`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.moe_gemm.ops import grouped_gemm
from repro_torch.models import common

Params = Dict[str, Any]
Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden
    capacity_factor: float = 1.25
    act: str = "silu"
    router_aux_coef: float = 0.01  # Switch/OLMoE load-balance loss

    def capacity(self, n_tokens: int) -> int:
        cap = int(math.ceil(self.capacity_factor * n_tokens * self.top_k
                            / self.n_experts))
        return max(cap, self.top_k)


def _edf_init(gen: torch.Generator, shape, scale: float, dtype,
              device) -> Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (w * scale).to(dtype)


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig, dtype,
             device) -> Params:
    """Router in fp32 (as the reference fixes it); experts `[E, in, out]`
    in `dtype` with fan-in truncated-normal scales."""
    e, f = cfg.n_experts, cfg.d_ff
    scale, fscale = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(f)
    return {
        "router": common.dense_init(gen, d_model, e, torch.float32, device),
        "w_gate": _edf_init(gen, (e, d_model, f), scale, dtype, device),
        "w_up": _edf_init(gen, (e, d_model, f), scale, dtype, device),
        "w_down": _edf_init(gen, (e, f, d_model), fscale, dtype, device),
    }


def _route(params: Params, cfg: MoEConfig, x: Tensor, cap: int
           ) -> Tuple[Tensor, Tensor]:
    """x: [R, T, D], each of the R rows dispatched on its own with capacity
    `cap` per expert.  Returns (out [R, T, D], aux loss fp32 scalar)."""
    r, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    nk = t * k
    dev = x.device

    logits = x.float() @ params["router"].float()                # [R,T,E]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1, sorted=True)       # [R,T,K]
    topv = topv / topv.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # Load-balance aux loss (Switch eq. 4): E * sum_e f_e * p_e.  Counts
    # are sums of ones, exact in fp32 whatever the order of the adds.
    me = probs.mean(dim=(0, 1))
    counts = torch.zeros(e, dtype=torch.float32, device=dev).scatter_add_(
        0, topi.reshape(-1), torch.ones(r * nk, dtype=torch.float32,
                                        device=dev))
    aux = cfg.router_aux_coef * e * torch.sum(me * counts / (r * nk))

    # --- dispatch (per row) ------------------------------------------------
    flat_expert = topi.reshape(r, nk)        # pair i is (token i // k, i % k)
    order = torch.argsort(flat_expert, dim=1, stable=True)
    sexp = flat_expert.gather(1, order)
    experts = torch.arange(e, device=dev).expand(r, e).contiguous()
    group_start = torch.searchsorted(sexp, experts, right=False)  # [R,E]
    pos = torch.arange(nk, device=dev)[None] - group_start.gather(1, sexp)
    valid = pos < cap
    rows = torch.arange(r, device=dev)[:, None]
    slot = sexp * (r * cap) + rows * cap + pos.clamp_max(cap - 1)
    spare = e * r * cap                      # dropped pairs land here
    stok = order // k

    buf = torch.zeros((spare + 1, d), dtype=x.dtype, device=dev)
    buf[torch.where(valid, slot, spare)] = x[rows, stok]
    xb = buf[:spare].view(e, r * cap, d)

    # --- expert GEMMs --------------------------------------------------------
    g = grouped_gemm(xb, params["w_gate"])
    u = grouped_gemm(xb, params["w_up"])
    h = common.ACTS[cfg.act](g) * u
    y = grouped_gemm(h, params["w_down"]).view(spare, d)

    # --- combine: back to (token, k) order, weight, sum over k --------------
    slot_u = torch.empty_like(slot).scatter_(1, order, slot)
    valid_u = torch.empty_like(valid).scatter_(1, order, valid)
    weight = (topv.reshape(r, nk) * valid_u).to(x.dtype)
    per_pair = y[slot_u] * weight[..., None]                     # [R,NK,D]
    return per_pair.view(r, t, k, d).sum(dim=2), aux


def moe_apply(params: Params, cfg: MoEConfig, x: Tensor
              ) -> Tuple[Tensor, Tensor]:
    """x: [B, S, D] -> (out [B, S, D], aux loss fp32 scalar).  Per-row
    dispatch with capacity(S) for S > 1; S == 1 (decode) groups the whole
    batch (`_moe_apply_flat`)."""
    if x.shape[1] == 1:
        return _moe_apply_flat(params, cfg, x)
    return _route(params, cfg, x, cfg.capacity(x.shape[1]))


def _moe_apply_flat(params: Params, cfg: MoEConfig, x: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """Batch-grouped dispatch for decode: one (token, k) pool over the
    n = B * S tokens, capacity(n) per expert."""
    b, s, d = x.shape
    out, aux = _route(params, cfg, x.reshape(1, b * s, d),
                      cfg.capacity(b * s))
    return out.reshape(b, s, d), aux
