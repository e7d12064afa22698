"""Trees of the PyTorch port: nested dicts, lists and tuples (named tuples
among them) with tensors at the leaves, as the model's parameters
(``Model.params()``), their gradients and the optimizer's state are kept.
The reference walks the same shapes with ``jax.tree_util``."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple


def _children(tree) -> Iterator[Tuple[str, Any]]:
    """(key, child) of a node: a dict's keys, a named tuple's field names,
    a list's or tuple's indices."""
    if isinstance(tree, dict):
        yield from ((str(k), v) for k, v in tree.items())
    elif hasattr(tree, "_fields"):
        yield from zip(tree._fields, tree)
    else:
        yield from ((str(i), v) for i, v in enumerate(tree))


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves(tree) -> list:
    """The leaves of ``tree`` in order: dicts in insertion order, sequences
    by index."""
    return [leaf for _, leaf in flatten(tree)]


def flatten(tree, prefix: str = "") -> list:
    """(path, leaf) of every leaf, the path its keys joined by "/" (the
    reference's checkpoint keys are joined so)."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for k, child in _children(tree):
        out.extend(flatten(child, f"{prefix}/{k}" if prefix else k))
    return out


def map_tree(fn: Callable, tree, *rest):
    """``tree``'s structure with ``fn(leaf, *leaves of rest)`` at each leaf;
    ``rest`` are trees of the same structure."""
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    children = [map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    if hasattr(tree, "_fields"):
        return type(tree)(*children)
    return type(tree)(children)


def unflatten(template, values: Dict[str, Any]):
    """``template``'s structure with the value of each leaf's path taken
    from ``values`` (as ``flatten`` names them)."""
    paths = iter([path for path, _ in flatten(template)])
    return map_tree(lambda _: values[next(paths)], template)
