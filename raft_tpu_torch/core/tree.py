"""A small tree helper — the port's stand-in for ``jax.tree.leaves`` and
the JAX package's ``compat.tree_map`` over the shapes the serving
executor demuxes: tuples (named ones too), lists, dicts and dataclass
instances, nested. Anything else is a leaf; ``None`` is an empty
subtree, as in JAX. Dict keys are visited in sorted order and dataclass
fields in declaration order, so :func:`leaves` and :func:`tree_map`
agree on the order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

__all__ = ["leaves", "tree_map"]


def _is_dataclass_instance(x) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in traversal order."""
    out: List[Any] = []

    def walk(x):
        if x is None:
            return
        if isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif _is_dataclass_instance(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name))
        else:
            out.append(x)

    walk(tree)
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf, the containers
    rebuilt with their own types (a dataclass through
    ``dataclasses.replace``, so its ``__post_init__`` runs again)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        vals = [tree_map(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    if isinstance(tree, list):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, tree[k])) for k in sorted(tree))
    if _is_dataclass_instance(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init
        })
    return fn(tree)
