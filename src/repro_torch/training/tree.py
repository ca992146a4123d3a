"""Trees of the port's training state: nested dicts, lists, tuples and
NamedTuples with tensors (or numpy values) at the leaves.

Leaves are visited in the order JAX's `tree_flatten_with_path` visits the
same structure (dict keys sorted, sequences by index, NamedTuples by
field) and named by the same path (dict keys, sequence indices and
NamedTuple field names joined by "/"), so a checkpoint keyed by path
(`training/checkpoint.py`) reads the same in either package.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _children(node: Any):
    """(name, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _walk(node: Any, path: Tuple[str, ...], out: List[Tuple[str, Any]]
          ) -> None:
    kids = _children(node)
    if kids is None:
        out.append(("/".join(path), node))
        return
    for name, child in kids:
        _walk(child, path + (str(name),), out)


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf, in JAX's order."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, (), out)
    return out


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def _build(node: Any, it: Iterator[Any]) -> Any:
    if isinstance(node, dict):
        built = {k: _build(node[k], it) for k in sorted(node)}
        return {k: built[k] for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_build(c, it) for c in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_build(c, it) for c in node)
    return next(it)


def unflatten(template: Any, values: List[Any]) -> Any:
    """`template`'s structure with its leaves replaced by `values`, taken in
    `flatten_with_paths` order.  (Module-level recursion: a nested
    recursive function would sit in a reference cycle with the values,
    keeping a step's tensors alive until the garbage collector runs.)"""
    it = iter(values)
    out = _build(template, it)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` applied leafwise to `tree` and trees of the same structure."""
    cols = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
