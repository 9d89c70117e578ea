"""Nested containers of tensors ("trees"), walked in JAX's order.

The reference's training code maps over pytrees with ``jax.tree``: dicts
in sorted key order, NamedTuples by field, tuples and lists by position,
``None`` an empty subtree. The port's optimizer and checkpoints walk the
same containers in the same order: ``optim.global_norm`` sums its leaves in
it, and ``distributed.checkpoint`` names each leaf by its path
(``"state/1/m/embed"``), so a checkpoint's files are the reference's.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """``[(path, leaf)]`` in JAX's flatten order; a path holds dict keys,
    NamedTuple field names and sequence positions."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], path + (k,))
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += flatten_with_path(getattr(tree, name), path + (name,))
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, x in enumerate(tree):
            out += flatten_with_path(x, path + (i,))
        return out
    if tree is None:
        return []
    return [(path, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has ``tree``'s
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def map_with_path(fn: Callable[[tuple, Any], Any], tree: Any,
                  path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves; the result has ``tree``'s
    structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, x, path + (i,))
                          for i, x in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)
