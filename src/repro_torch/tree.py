"""Trees of tensors by path: nested dicts and NamedTuples (a train state),
their leaves keyed by the checkpoint's ``/``-joined paths
(``periods/pos0/attn/wq``, ``opt/m/embed``).

A NamedTuple nests by its field names in field order and ``None`` holds no
leaf, as in a JAX pytree.  Dicts are walked in their own order, or with
``sort=True`` in sorted key order (the order ``jax.tree_util`` flattens
them in, which the checkpoint's file keeps).
"""
from __future__ import annotations

from typing import Any, Callable


def _is_record(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any, sort: bool):
    if _is_record(node):
        return [(k, getattr(node, k)) for k in node._fields]
    return [(k, node[k]) for k in (sorted(node) if sort else node)]


def paths(tree: Any, prefix: str = "", *, sort: bool = False) -> dict:
    """{path: leaf} of ``tree``."""
    out: dict = {}
    _collect(tree, prefix, sort, out)
    return out


def _collect(node: Any, prefix: str, sort: bool, out: dict) -> None:
    if node is None:
        return
    if not (isinstance(node, dict) or _is_record(node)):
        out[prefix] = node
        return
    for key, sub in _children(node, sort):
        _collect(sub, f"{prefix}/{key}" if prefix else str(key), sort, out)


def tree_map(fn: Callable, tree: Any, *, sort: bool = False) -> Any:
    """``fn`` on every leaf, in :func:`paths`' order, same structure (with
    ``sort=True`` dicts come back with their keys sorted)."""
    # module-level recursion: a recursive closure would form a reference
    # cycle that keeps every tensor it built alive until the next garbage
    # collection, so a released model would not free the card's memory
    if tree is None:
        return None
    if _is_record(tree):
        return type(tree)(*(tree_map(fn, v, sort=sort) for _, v in _children(tree, sort)))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, sort=sort) for k, v in _children(tree, sort)}
    return fn(tree)


def unflatten_like(tree: Any, leaves, *, sort: bool = False) -> Any:
    """``tree``'s structure with ``leaves`` (in :func:`paths`' order) in
    place of its own."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree, sort=sort)
