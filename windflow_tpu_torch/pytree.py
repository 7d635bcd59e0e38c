"""The state pytrees of the keyed operators: flatten and rebuild nested
dicts, lists and tuples of leaves.

Dict keys flatten in SORTED order, as ``jax.tree_util`` flattens them, so
a state table's leaf order — the column order of a cold-tier row and the
byte order of ``state.tiered.hot_table_digest`` — is the JAX package's.
Anything that is not a dict, list or tuple is a leaf (a bare scalar state
is a one-leaf tree).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, spec)``; ``tree_unflatten(spec, leaves)`` rebuilds."""
    leaves: List[Any] = []

    def walk(t):
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", keys, [walk(t[k]) for k in keys])
        if isinstance(t, (list, tuple)):
            return (type(t), None, [walk(x) for x in t])
        leaves.append(t)
        return None

    return leaves, walk(tree)


def tree_unflatten(spec, leaves) -> Any:
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, kids = s
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, kids)}
        return kind(build(c) for c in kids)

    return build(spec)


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    leaves, spec = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])
