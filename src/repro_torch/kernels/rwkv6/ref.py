"""Plain PyTorch WKV6: the CPU path of `ops.wkv6` and the oracle its CUDA
kernel is held to on the card.

- `wkv6_chunked_ref`: step for step `repro.models.rwkv6.wkv6_chunked`,
  mid-chunk renormalisation included;
- `wkv6_step_ref`: `repro.models.rwkv6.wkv6_decode`, one token;
- `wkv6_sequential`: the oracle `repro.kernels.rwkv6.ref.wkv6_sequential`.

All three take r/k/v [B, S, H, N] in the compute dtype, logw fp32
[B, S, H, N], bonus [H, N] and the state fp32 [B, H, N, N] (indexed [key,
value]); they work in fp32 and return (y fp32 [B, S, H, N], the final
state), leaving the given state as it was.

`wkv6_bwd_ref` is the plain backward: autograd of `wkv6_chunked_ref`.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def wkv6_chunked_ref(r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
                     bonus: Tensor, state: Tensor, chunk: int
                     ) -> Tuple[Tensor, Tensor]:
    b, s, h, n = r.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"seq {s} not divisible by chunk {c}")
    nc = s // c
    rf, kf, vf, lw = (a.float().reshape(b, nc, c, h, n)
                      for a in (r, k, v, logw))
    u = bonus.float()
    S = state.float()
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    ys = []
    for ci in range(nc):
        rc, kc, vc, lwc = rf[:, ci], kf[:, ci], vf[:, ci], lw[:, ci]
        cum = torch.cumsum(lwc, dim=1)                   # inclusive
        cum_excl = cum - lwc                             # exclusive prefix
        total = cum[:, -1:]                              # [B, 1, H, N]

        # Inter-chunk: y_i += (r_i * exp(cum_excl_i)) . S
        y_inter = torch.einsum("bchn,bhnm->bchm", rc * torch.exp(cum_excl),
                               S)

        # Intra-chunk (strictly past), with mid-chunk renormalisation.
        mid = cum[:, c // 2 - 1:c // 2] if c > 1 else cum[:, :1]
        r_n = rc * torch.exp(cum_excl - mid)
        k_n = kc * torch.exp(mid - cum)
        A = torch.einsum("bihn,bjhn->bhij", r_n, k_n)
        A = torch.where(mask, A, torch.zeros((), device=A.device))
        y_intra = torch.einsum("bhij,bjhn->bihn", A, vc)

        # Bonus (current token): y_i += (r_i . (u * k_i)) v_i
        dot = torch.einsum("bchn,bchn->bch", rc, u * kc)
        ys.append(y_inter + y_intra + dot[..., None] * vc)

        # S' = diag(exp(total)) S + sum_j exp(total - cum_j) k_j v_j^T
        k_fut = kc * torch.exp(total - cum)
        S = torch.exp(total)[:, 0, :, :, None] * S + torch.einsum(
            "bchn,bchm->bhnm", k_fut, vc)
    return torch.stack(ys, dim=1).reshape(b, s, h, n), S


def wkv6_step_ref(r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
                  bonus: Tensor, state: Tensor) -> Tuple[Tensor, Tensor]:
    """One token: r/k/v/logw [B, 1, H, N]."""
    rf, kf, vf = (a.float()[:, 0] for a in (r, k, v))
    w = torch.exp(logw.float()[:, 0])                    # [B, H, N]
    kv = torch.einsum("bhn,bhm->bhnm", kf, vf)
    y = torch.einsum("bhn,bhnm->bhm", rf,
                     state.float() + bonus.float()[None, :, :, None] * kv)
    return y[:, None], w[..., None] * state.float() + kv


def wkv6_sequential(r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
                    bonus: Tensor, state: Tensor) -> Tuple[Tensor, Tensor]:
    """Token-by-token recurrence (ground truth)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(logw.float())
    uf = bonus.float()
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhn,bhm->bhnm", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, t],
                               S + uf[None, :, :, None] * kv))
        S = wf[:, t, ..., None] * S + kv
    return torch.stack(ys, dim=1), S


def wkv6_bwd_ref(dy: Tensor, r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
                 bonus: Tensor, state: Tensor, chunk: int
                 ) -> Tuple[Tensor, ...]:
    """Gradients of y = `wkv6_chunked_ref(...)[0]` given dy (fp32, y's
    shape), the initial state a constant (the final state's gradient is
    not taken): (dr, dk, dv in r's dtype, dlogw fp32, dbonus in bonus's
    dtype), by autograd on detached copies of the inputs."""
    leaves = [t.detach().requires_grad_(True)
              for t in (r, k, v, logw, bonus)]
    with torch.enable_grad():
        y, _ = wkv6_chunked_ref(*leaves, state.detach().clone(), chunk)
        return torch.autograd.grad(y, leaves, dy)
