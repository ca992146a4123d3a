"""Plain PyTorch RG-LRU: the CPU path of `ops.rglru` and `ops.rglru_gated`
and the oracle their CUDA kernel is held to on the card.

The recurrence is h_t = exp(log_a_t) * h_{t-1} + b_t per channel, from an
initial state h0:

- `rglru_scan_ref`: the sequential oracle, step by step
  `repro.kernels.rglru.ref.rglru_scan_ref` plus the initial state (which
  that oracle, like the Pallas kernel, does not take: there h0 = 0);
- `rglru_assoc_ref`: the associative-scan form the reference model runs
  (`repro.models.rglru.rglru_scan`): a_0 * h0 folded into b_0, then the
  combine (a1, b1), (a2, b2) -> (a1 * a2, a2 * b1 + b2) over the sequence,
  evaluated here as a log-depth doubling scan;
- `rglru_step_ref`: the one-token step (`repro.models.rglru.rglru_step`).

All three take log_a and b fp32 [B, S, W] and h0 fp32 [B, W], and return
(h fp32 [B, S, W], h_last fp32 [B, W]), leaving h0 as it was.

`rglru_gates_ref` makes that log_a and b from the gate pre-activations,
as the reference model's `_rglru_gates` (`repro.models.rglru`) does.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

#: The constant c of log a = -c softplus(lambda) r (Griffin's 8).
LRU_C = 8.0


def rglru_gates_ref(za: Tensor, zi: Tensor, y: Tensor, b_a: Tensor,
                    b_i: Tensor, lru_lambda: Tensor) -> Tuple[Tensor, Tensor]:
    """log_a and the gated input b, both fp32 [B, S, W], from the gate
    pre-activations za = y @ w_a and zi = y @ w_i and the block's input y
    ([B, S, W], any float type) and fp32 [W] b_a, b_i and lru_lambda:
    r = sigmoid(za + b_a), i = sigmoid(zi + b_i),
    log_a = -c softplus(lambda) r, b = sqrt(max(1 - a^2, 1e-9)) (i y)."""
    r = torch.sigmoid(za.float() + b_a)
    i = torch.sigmoid(zi.float() + b_i)
    log_a = -LRU_C * F.softplus(lru_lambda) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-9)) * (i * y.float())
    return log_a, gated


def rglru_scan_ref(log_a: Tensor, b: Tensor, h0: Tensor = None
                   ) -> Tuple[Tensor, Tensor]:
    """Sequential walk from `h0` (zero when None)."""
    h = torch.zeros_like(b[:, 0]) if h0 is None else h0.float()
    hs = []
    for t in range(log_a.shape[1]):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_assoc_ref(log_a: Tensor, b: Tensor, h0: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """The reference model's associative scan, as a doubling scan."""
    a = torch.exp(log_a)
    bb = torch.cat([(b[:, 0] + a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
    off = 1
    while off < a.shape[1]:
        bb = torch.cat([bb[:, :off], a[:, off:] * bb[:, :-off] + bb[:, off:]],
                       dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return bb, bb[:, -1]


def rglru_step_ref(log_a: Tensor, b: Tensor, h0: Tensor
                   ) -> Tuple[Tensor, Tensor]:
    """One token: log_a, b [B, 1, W]."""
    h = torch.exp(log_a[:, 0]) * h0 + b[:, 0]
    return h[:, None], h
