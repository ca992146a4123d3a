"""Plain PyTorch RG-LRU scan: the CPU path of `ops.rglru` and the oracle its
CUDA kernel is held to on the card.

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
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


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
