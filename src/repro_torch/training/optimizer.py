"""AdamW with linear warmup and cosine decay, the port of
`repro.training.optimizer`.

The state mirrors the params tree: m and v in fp32 on each leaf's device,
and the step count, an int32 0-d tensor on the params' device.  The math is
fp32 and params keep their dtype.  Nothing here syncs with the host: the
learning rate, the bias corrections and the clip scale are device scalars.

`apply` updates params, m and v in place and returns them (the reference's
functional update returns new trees; in place saves a copy of each).

Weight decay follows the reference's choice of leaves.  It decays a leaf
of more than one dimension; its per-layer (per-block) leaves are stacked
on a leading axis, so every layer's norm scales and biases decay too, and
only the unstacked 1-D leaves (final norms) do not.  The port keeps those
groups as lists of per-layer dicts, so a leaf under a key of `STACKED`
counts that axis: it decays if `ndim + 1 > 1`, as the reference's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.training import tree as tree_mod

Tensor = torch.Tensor

#: Top-level keys whose subtrees the reference stacks over layers or
#: blocks: the transformer's and rwkv6's "layers", recurrentgemma's three
#: block groups, the encoder-decoder's two layer stacks.  (recurrentgemma's
#: "norms_temporal" / "norms_mlp" are [n_layers, d] arrays in both
#: packages and need no entry.)
STACKED = ("layers", "rec_blocks", "attn_blocks", "mlps", "enc_layers",
           "dec_layers")


class AdamWState(NamedTuple):
    step: Tensor         # int32 0-d
    m: Any               # tree like params (fp32)
    v: Any               # tree like params (fp32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, fp32 on step's
    device."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def init(params: Any) -> AdamWState:
    flat = tree_mod.leaves(params)
    device = flat[0].device if flat else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_mod.tree_map(zeros, params),
                      v=tree_mod.tree_map(zeros, params))


def global_norm(tree: Any) -> Tensor:
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree_mod.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, Tensor]:
    """(tree scaled to global norm <= max_norm, in fp32; the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_mod.tree_map(lambda g: g.to(torch.float32) * scale,
                             tree), norm


def decays(path: str, p: Tensor) -> bool:
    """Whether weight decay applies to the leaf at `path`: the reference's
    `ndim > 1`, counting the layer axis it stacks under `STACKED`."""
    ndim = p.dim() + (1 if path.split("/")[0] in STACKED else 0)
    return ndim > 1


def apply(cfg: AdamWConfig, params: Any, grads: Any, state: AdamWState,
          ) -> Tuple[Any, AdamWState, Dict[str, Tensor]]:
    """One AdamW update.  Grads may be any float dtype; math in fp32;
    params keep their dtype.  Updates params, m and v in place."""
    with torch.no_grad():
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        step = state.step + 1
        lr = lr_at(cfg, step)
        b1, b2 = cfg.b1, cfg.b2
        t = step.to(torch.float32)
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        for (path, p), g, m, v in zip(tree_mod.flatten_with_paths(params),
                                      tree_mod.leaves(grads),
                                      tree_mod.leaves(state.m),
                                      tree_mod.leaves(state.v)):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            pf = p.to(torch.float32)
            if decays(path, p):
                delta = delta + cfg.weight_decay * pf
            p.copy_(pf - lr * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step=step, m=state.m, v=state.v), metrics
