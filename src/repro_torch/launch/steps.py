"""Step functions of the port, the counterpart of `repro.launch.steps`
(executed by launch/train.py and the tests):

    train_step  : (params, opt_state, batch) -> (params, opt_state, metrics)
    prefill_step: (params, inputs)           -> (logits, cache)
    serve_step  : (params, cache, token, pos)-> (logits, cache)

PyTorch runs eagerly, so nothing is lowered or jitted: each step is a
plain function over the port's tensors.

Data parallelism: given a process group, the train step all-reduces its
gradients (and its loss) as a mean over the group's ranks, in fp32, in
one collective, before the clip and the AdamW update, so every rank
updates the same parameters from the global batch's gradient.  That is
the reference's step sharded over a mesh's data axis: `lm_loss` is a mean
over tokens and every rank holds as many tokens as the others.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.distributed import collectives
from repro_torch.models.registry import ModelBundle
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import tree as tree_mod
from repro_torch.training.optimizer import AdamWConfig


def _all_reduce_mean(grads, loss, group):
    """The gradients and the loss averaged over `group`'s ranks in fp32, in
    one all-reduce of a flat buffer: (fp32 gradients, views of the buffer;
    the loss, a copy, so that the buffer dies with the step; the
    collective as the ring model counts it)."""
    import torch.distributed as dist
    world = dist.get_world_size(group)
    flat = torch.empty(sum(g.numel() for g in grads) + 1,
                       dtype=torch.float32, device=loss.device)
    out, at = [], 0
    for g in grads:
        part = flat[at:at + g.numel()]
        part.copy_(g.reshape(-1))
        out.append(part.view(g.shape))
        at += g.numel()
    flat[-1] = loss.detach()
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(world)
    comm = collectives.op("all-reduce", "f32", flat.shape,
                          flat.numel() * flat.element_size(), world)
    return out, flat[-1].clone(), comm


def make_train_step(bundle: ModelBundle, opt_cfg: AdamWConfig,
                    compress_grads: Optional[Callable] = None,
                    group=None):
    """Forward + backward through `bundle.loss_fn`, then AdamW.
    `compress_grads(tree) -> tree` optionally transforms the gradients
    (int8 compression with error feedback, training/compression.py).
    `group`: a process group to train data-parallel over (the batch given
    is this rank's rows): the gradients and the loss are averaged over its
    ranks in fp32 before `compress_grads`, the clip and AdamW, and
    `train_step.comm` holds the all-reduce's `collectives.summarize`.
    `metrics` are {loss, grad_norm, lr}, device tensors: the step makes no
    host sync.  Params and the optimizer state are updated in place
    (`optimizer.apply`) and returned."""

    def train_step(params, opt_state, batch):
        flat = tree_mod.leaves(params)
        with torch.enable_grad():
            for p in flat:
                p.requires_grad_(True)
            try:
                loss = bundle.loss_fn(params, batch)
                # Every leaf is reached: a leaf the graph misses (a kernel
                # without a backward) raises here, not a silent zero.
                grads = torch.autograd.grad(loss, flat)
            finally:
                for p in flat:
                    p.requires_grad_(False)
        if group is not None:
            grads, loss, comm = _all_reduce_mean(grads, loss, group)
            train_step.comm = collectives.summarize([comm])
        grads = tree_mod.unflatten(params, list(grads))
        if compress_grads is not None:
            grads = compress_grads(grads)
        params, opt_state, metrics = opt_mod.apply(opt_cfg, params, grads,
                                                   opt_state)
        metrics = dict(metrics, loss=loss.detach())
        return params, opt_state, metrics

    train_step.comm = None
    return train_step


def make_prefill_step(bundle: ModelBundle, cache_len: int):
    """Prompt -> (last-token logits, filled cache), the cache made on the
    tokens' device."""

    def prefill_step(params, **inputs):
        tokens = inputs["tokens"]
        cache = bundle.init_cache(tokens.shape[0], cache_len, tokens.device)
        if bundle.family == "encdec":
            return bundle.prefill(params, inputs, cache)
        inputs = dict(inputs)
        return bundle.prefill(params, inputs.pop("tokens"), cache, **inputs)

    return prefill_step


def make_serve_step(bundle: ModelBundle):
    """One decode token for the whole batch against an existing cache."""

    def serve_step(params, cache, token, pos):
        return bundle.decode_step(params, token, cache, pos)

    return serve_step
