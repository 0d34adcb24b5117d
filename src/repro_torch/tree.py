"""Nested containers of tensors (the port's pytrees), flattened as JAX does.

The training modules hold params, gradients and optimizer state as nested
dicts, lists, tuples and named tuples with tensors at the leaves.  These
helpers walk them in the order ``jax.tree_util`` does (dict keys sorted,
sequences and named-tuple fields in order, ``None`` an empty subtree), so a
global norm sums its leaves in the reference's order and a checkpoint's
``leaf_<i>`` files line up with the reference's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    """(path entry, child) pairs of a container, in JAX's order; [] for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return []


def _is_container(node) -> bool:
    return isinstance(node, (dict, list, tuple)) or node is None


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """Every leaf with its ``/``-joined path, in JAX's leaf order (the keys
    the reference's checkpoints write)."""
    if tree is None:
        return []
    if not _is_container(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += flatten_with_paths(child, f"{prefix}/{key}" if prefix else key)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(tree, new_leaves):
    """``tree``'s structure with its leaves replaced, in order, by ``new_leaves``."""
    it = iter(new_leaves)

    def rebuild(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: rebuild(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}  # the caller's key order
        if _is_namedtuple(node):
            return type(node)(*[rebuild(getattr(node, f)) for f in node._fields])
        if isinstance(node, (list, tuple)):
            return type(node)(rebuild(c) for c in node)
        return next(it)

    out = rebuild(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    mine = leaves(tree)
    if any(len(o) != len(mine) for o in others):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(mine, *others)])
