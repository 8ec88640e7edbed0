"""The leaves of a state tree, in the JAX package's flatten order.

A tree is built of tuples and lists (in order), dicts (keys sorted), named
tuples and dataclasses (fields in declaration order); None is an empty
subtree and anything else a leaf. Each leaf's path reads as JAX's
``jax.tree_util.keystr`` of it (``.tt_cores[1]``, ``['w']``), so a
checkpoint's leaves line up with the JAX package's and a non-finite leaf
is named as the JAX package names it. Used by ``utils.checkpoint`` and
``utils.guard``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]] | None:
    """(path step, child) pairs of a container, None for a leaf."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{name}", getattr(tree, name)) for name in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    return None


def leaves_with_paths(tree) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf of ``tree``, in flatten order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("", tree)]
    return [(step + path, leaf) for step, child in kids
            for path, leaf in leaves_with_paths(child)]


def map_leaves(fn: Callable[[Any], Any], tree):
    """``tree`` rebuilt with every leaf replaced by ``fn(leaf)``, the leaves
    visited in flatten order."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_leaves(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_leaves(fn, c) for c in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_leaves(fn, c) for c in tree)
    if isinstance(tree, dict):
        new = {k: map_leaves(fn, tree[k]) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    return fn(tree)
