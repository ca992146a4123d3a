"""Parameter / input / cache sharding specs for every model family, the
port of `repro.distributed.sharding`.

A spec is a plain tuple with one entry a tensor dimension: None
(replicated), an axis name, or a tuple of axis names (the dimension split
over several mesh axes, major first) — the port's analogue of a
`PartitionSpec`, written out to the tensor's rank (the reference's `P()`
is `(None,) * ndim` here, and a one-name tuple is the name, as `P`
normalizes it).  `placements(mesh, spec)` turns a spec into
`torch.distributed.tensor` placements over a `DeviceMesh`.

Axis conventions (launch/mesh.py):
  single-pod : ("data", "model")
  multi-pod  : ("pod", "data", "model")

The batch axis shards over ("pod", "data") (pure DP across pods); tensor /
expert / sequence parallelism live on "model".  Rules are path-based over
the parameter tree.  GQA caches: when n_kv_heads is not divisible by the
model-axis size the KV *sequence* dim is sharded instead (split-K decode),
which is also what makes long_500k batch=1 shardable at all.

Where the trees differ.  The reference stacks each layer group on a
leading axis (`layers/attn/wq` [L, d, d]); the port keeps one leaf a layer
(`layers/0/attn/wq` [d, d]; `rec_blocks/0/w_x`, `mlps/0/w_gate`,
`attn_blocks/0/attn/wq`, `enc_layers/0/...`, `dec_layers/0/...`;
`layers/0/moe/w_gate` [E, d, f]).  A port path is matched against the
rules with its layer index left out, and the spec is built for the leaf's
own shape, so it equals the reference's with its leading layer entry
dropped.  Leaves that both packages keep whole (recurrentgemma's
`norms_temporal/scale` and `norms_mlp/scale` [n_layers, d], the
embeddings, the final norms) take the reference's spec as it is.

The caches are stacked [L, B, ...] in both packages under the same keys,
each mapped to the reference rule of the same name:
  global/k, global/v, local/k, local/v   (transformer; `k_scale`/`v_scale`
  self/k, self/v, cross/k, cross/v        of the int8 cache likewise)
  attn/k, attn/v                          (recurrentgemma's attention)
                                          -> the KV rule [L, B, S, KVH, HD]
  wkv                                     -> [L, B, H, N, N], heads on model
  tm_shift, cm_shift                      -> [L, B, D], batch only
  lru_h                                   -> [L, B, W], width on model
  conv_tail                               -> [L, B, 3, W], width on model
  memory_len (0-d)                        -> replicated
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Mapping, Tuple, Union

from repro_torch.models.registry import ModelBundle
from repro_torch.training import tree as tree_mod

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class Axes:
    """Logical axis names for the current mesh."""
    data: Tuple[str, ...] = ("data",)     # batch axes (may include "pod")
    model: str = "model"

    @staticmethod
    def for_mesh(mesh) -> "Axes":
        if "pod" in mesh_sizes(mesh):
            return Axes(data=("pod", "data"), model="model")
        return Axes(data=("data",), model="model")


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, or of a mapping given as
    such (a mesh shaped like a pod's, no devices needed)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _entry(names: Tuple[str, ...]) -> Entry:
    return names[0] if len(names) == 1 else tuple(names)


def _rule_path(path: str) -> str:
    """A port path with its layer indices left out: the reference's."""
    return "/".join(p for p in path.split("/") if not p.isdigit())


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

_COL = "COL"    # shard last dim (output features) on model axis
_ROW = "ROW"    # shard second-to-last dim (input features) on model axis
_VOCAB = "VOCAB"
_REP = "REP"

# Rules are tried in order; first regex match wins (the reference's table).
_PARAM_RULES = [
    # --- MoE (mode-dependent; handled specially below) --------------------
    (re.compile(r".*moe/router$"), _REP),
    (re.compile(r".*moe/w_(gate|up)$"), "MOE_IN"),
    (re.compile(r".*moe/w_down$"), "MOE_OUT"),
    # --- attention ---------------------------------------------------------
    (re.compile(r".*attn/w[qkv]$"), _COL),
    (re.compile(r".*attn/wo$"), _ROW),
    (re.compile(r".*attn/b[qkv]$"), _COL),
    (re.compile(r".*attn/bo$"), _REP),
    (re.compile(r".*attn/(q|k)_norm.*"), _REP),
    # --- dense / gated MLP --------------------------------------------------
    (re.compile(r".*mlp.?/w_(gate|up|in)$"), _COL),
    (re.compile(r".*mlp.?/w_(down|out)$"), _ROW),
    (re.compile(r".*mlp.?/b_(gate|up|in)$"), _COL),
    (re.compile(r".*mlp.?/b_(down|out)$"), _REP),
    # --- rwkv6 time/channel mix --------------------------------------------
    (re.compile(r".*time_mix/w[rkvg]$"), _COL),
    (re.compile(r".*time_mix/wo$"), _ROW),
    (re.compile(r".*time_mix/bonus$"), "HEAD0"),
    (re.compile(r".*time_mix/(maa|decay).*"), _REP),
    (re.compile(r".*channel_mix/wk$"), _COL),
    (re.compile(r".*channel_mix/wv$"), _ROW),
    (re.compile(r".*channel_mix/wr$"), _COL),
    (re.compile(r".*channel_mix/(maa).*"), _REP),
    # --- rglru ---------------------------------------------------------------
    (re.compile(r".*rec_blocks/w_(x|gate)$"), _COL),
    (re.compile(r".*rec_blocks/w_out$"), _ROW),
    (re.compile(r".*rec_blocks/conv_[wb]$"), "LAST"),
    (re.compile(r".*rec_blocks/(w_a|w_i)$"), _COL),
    (re.compile(r".*rec_blocks/(b_a|b_i|lru_lambda)$"), "LAST"),
    # --- embeddings ----------------------------------------------------------
    (re.compile(r"^embedding$"), _VOCAB),
    (re.compile(r"^lm_head$"), _VOCAB),
    # --- norms & everything small -------------------------------------------
    (re.compile(r".*"), _REP),
]


def _spec_for(kind: str, shape, axes: Axes, moe_mode: str,
              msize: int) -> Spec:
    """Build the spec, dropping any axis whose dim is not divisible by the
    model-axis size (an even split needs exact divisibility)."""
    m = axes.model
    ndim = len(shape)

    def pad(spec_tail):
        spec = [None] * (ndim - len(spec_tail)) + list(spec_tail)
        # divisibility guard
        for i, ax in enumerate(spec):
            if ax == m and shape[i] % msize != 0:
                spec[i] = None
        return tuple(spec)

    if kind == _REP:
        return (None,) * ndim
    if kind == _COL:
        return pad([None, m]) if ndim >= 2 else pad([m])
    if kind == _ROW:
        return pad([m, None])
    if kind == "LAST":
        return pad([m])
    if kind == _VOCAB:
        # vocab-sharded when divisible, else shard d_model
        if shape[0] % msize == 0:
            return (m, None)
        if shape[1] % msize == 0:
            return (None, m)
        return (None, None)
    if kind == "HEAD0":
        # (H, N): shard head dim
        return pad([m, None])
    if kind == "MOE_IN":   # (E, d, f)
        if moe_mode == "expert":
            return pad([m, None, None])
        return pad([None, None, m])
    if kind == "MOE_OUT":  # (E, f, d)
        if moe_mode == "expert":
            return pad([m, None, None])
        return pad([None, m, None])
    raise ValueError(kind)


def param_spec(path: str, shape, axes: Axes, moe_mode: str = "expert",
               msize: int = 16) -> Spec:
    """The spec of the parameter at the port's `path` of `shape`."""
    rule_path = _rule_path(path)
    for rex, kind in _PARAM_RULES:
        if rex.match(rule_path):
            return _spec_for(kind, tuple(shape), axes, moe_mode, msize)
    return (None,) * len(shape)


def param_pspecs(bundle: ModelBundle, axes: Axes, msize: int = 16) -> Any:
    """Spec tree mirroring the parameter tree.  `msize` is the model-axis
    size (divisibility guard)."""
    moe_mode = "expert"
    moe = getattr(bundle.cfg, "moe", None)
    if moe is not None:
        moe_mode = moe.shard_mode
    abstract = bundle.abstract_params()
    return tree_mod.unflatten(abstract, [
        param_spec(path, leaf.shape, axes, moe_mode, msize)
        for path, leaf in tree_mod.flatten_with_paths(abstract)])


# ---------------------------------------------------------------------------
# Optimizer state specs (m/v mirror params; step replicated)
# ---------------------------------------------------------------------------

def opt_pspecs(bundle: ModelBundle, axes: Axes, msize: int = 16) -> Any:
    from repro_torch.training.optimizer import AdamWState
    p = param_pspecs(bundle, axes, msize)
    return AdamWState(step=(), m=p, v=p)


def spec_items(spec_tree: Any, prefix: str = "") -> List[Tuple[str, Spec]]:
    """(path, spec) of every spec in a spec tree, by the paths of
    `training/tree.py` (a spec tuple is a leaf; dicts, lists and
    NamedTuples are nodes)."""
    if isinstance(spec_tree, dict):
        kids = [(k, spec_tree[k]) for k in sorted(spec_tree)]
    elif isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        kids = list(zip(spec_tree._fields, spec_tree))
    elif isinstance(spec_tree, list):
        kids = list(enumerate(spec_tree))
    else:
        return [(prefix, spec_tree)]
    out: List[Tuple[str, Spec]] = []
    for name, child in kids:
        out += spec_items(child, f"{prefix}/{name}" if prefix else str(name))
    return out


# ---------------------------------------------------------------------------
# Input / cache specs
# ---------------------------------------------------------------------------

def batch_pspec(axes: Axes, ndim: int) -> Spec:
    return (_entry(axes.data),) + (None,) * (ndim - 1)


def input_pspecs(inputs: Dict[str, Any], axes: Axes, dsize: int = 16
                 ) -> Dict[str, Spec]:
    """Shard the leading (batch) dim of every input when divisible by the
    total data-axis size; scalars and small batches replicated."""
    def rule(leaf):
        if leaf.dim() == 0 or leaf.shape[0] % dsize != 0:
            return (None,) * leaf.dim()
        return batch_pspec(axes, leaf.dim())
    return {k: rule(v) for k, v in inputs.items()}


def _cache_spec(path: str, shape, axes: Axes, msize: int, dsize: int
                ) -> Spec:
    nd = len(shape)

    def dax(n) -> Entry:
        """data axes if batch size n divides, else None."""
        return _entry(axes.data) if n % dsize == 0 else None

    if nd == 0:
        return ()
    if re.search(r"(^|/)(k|v)(_scale)?$", path) and nd == 5:
        _, b, s, kvh, _ = shape
        b_spec = dax(b)
        kv_ok = kvh % msize == 0
        if b_spec is None and s % (dsize * msize) == 0 and not kv_ok:
            # batch=1 long-context: stack seq over data+model (split-K)
            return (None, None, axes.data + (axes.model,), None, None)
        if b_spec is None and s % dsize == 0 and kv_ok:
            return (None, None, _entry(axes.data), axes.model, None)
        if kv_ok:
            return (None, b_spec, None, axes.model, None)
        if s % msize == 0:
            return (None, b_spec, axes.model, None, None)
        return (None, b_spec, None, None, None)
    if path.endswith("wkv") and nd == 5:        # rwkv6 (L,B,H,N,N)
        _, b, h, _, _ = shape
        return (None, dax(b), axes.model if h % msize == 0 else None,
                None, None)
    if "shift" in path and nd == 3:             # (L,B,D)
        return (None, dax(shape[1]), None)
    if path.endswith("lru_h") and nd == 3:      # (L,B,W)
        return (None, dax(shape[1]),
                axes.model if shape[2] % msize == 0 else None)
    if path.endswith("conv_tail") and nd == 4:  # (L,B,3,W)
        return (None, dax(shape[1]), None,
                axes.model if shape[3] % msize == 0 else None)
    if nd >= 2:
        return (None, dax(shape[1])) + (None,) * (nd - 2)
    return (None,) * nd


def cache_pspecs(bundle: ModelBundle, cache: Any, axes: Axes, mesh
                 ) -> Any:
    """KV caches: (L, B, S, KVH, HD) -> batch on data; KVH on model when
    divisible, else S on model (split-K decode).  Recurrent states:
    (L, B, H, N, N) / (L, B, W): width/head dims on model.  `cache` is the
    port's cache tree (on the meta device for a dry run); `mesh` a
    `DeviceMesh` or its {axis: size}."""
    sizes = mesh_sizes(mesh)
    msize = sizes.get(axes.model, 1)
    dsize = math.prod(sizes[a] for a in axes.data)
    return tree_mod.unflatten(cache, [
        _cache_spec(path, tuple(leaf.shape), axes, msize, dsize)
        for path, leaf in tree_mod.flatten_with_paths(cache)])


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------

def placements(mesh, spec: Spec) -> List[Any]:
    """`torch.distributed.tensor` placements over `mesh` (a `DeviceMesh`)
    of a tensor laid out as `spec`: Shard(d) on each mesh dimension named
    by the spec's entry d, Replicate() on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry,) if isinstance(entry, str) else entry:
            i = names.index(name)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {name!r} shards "
                                 "two dimensions")
            out[i] = Shard(dim)
    return out

