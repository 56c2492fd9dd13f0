"""Parameter trees: nested dicts and lists of tensors.

The port's stand-in for the ``jax.tree`` functions the reference uses.
Leaves are visited depth first in insertion order, so two trees built the
same way flatten the same way.
"""
from __future__ import annotations

from typing import Callable, List


def leaves(tree) -> List:
    """Every non-container leaf (``None`` entries are skipped)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def map_(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), rebuilding the containers."""
    if isinstance(tree, dict):
        return {k: map_(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def unflatten(like, flat: List):
    """A tree shaped like ``like`` whose leaves are ``flat`` in order."""
    it = iter(flat)
    return map_(lambda _: next(it), like)
