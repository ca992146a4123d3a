"""Step functions of the port, the counterpart of `repro.launch.steps`
(executed by launch/train.py and the tests):

    train_step  : (params, opt_state, batch) -> (params, opt_state, metrics)
    prefill_step: (params, inputs)           -> (logits, cache)
    serve_step  : (params, cache, token, pos)-> (logits, cache)

PyTorch runs eagerly, so nothing is lowered or jitted: each step is a
plain function over the port's tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.registry import ModelBundle
from repro_torch.training import optimizer as opt_mod
from repro_torch.training import tree as tree_mod
from repro_torch.training.optimizer import AdamWConfig


def make_train_step(bundle: ModelBundle, opt_cfg: AdamWConfig,
                    compress_grads: Optional[Callable] = None):
    """Forward + backward through `bundle.loss_fn`, then AdamW.
    `compress_grads(tree) -> tree` optionally transforms the gradients
    (int8 compression with error feedback, training/compression.py).
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
        grads = tree_mod.unflatten(params, list(grads))
        if compress_grads is not None:
            grads = compress_grads(grads)
        params, opt_state, metrics = opt_mod.apply(opt_cfg, params, grads,
                                                   opt_state)
        metrics = dict(metrics, loss=loss.detach())
        return params, opt_state, metrics

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
