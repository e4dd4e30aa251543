"""Small parameter-tree helpers — the part of :mod:`repro.utils.trees` the
train step uses.  A tree is nested dicts (or tuples / lists) of tensors."""

from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_cast(tree, dtype: torch.dtype):
    """Every floating leaf to ``dtype`` — all of them, the SSM parameters
    ``A_log``, ``dt_bias`` and ``D`` included, as the reference's
    ``tree_cast`` does.  Differentiable."""
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
