"""Small parameter-tree helpers — the part of :mod:`repro.utils.trees` the
train step and the checkpoints use.  A tree is nested dicts, tuples, lists
and named tuples of tensors; ``None`` is an empty subtree, as in jax."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure).  Named tuples keep their type;
    ``None`` is an empty subtree, as in ``jax.tree.map``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    if tree is None:
        return []
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


def _children(tree) -> Iterator[Tuple[str, Any]]:
    """(path component, subtree) of a node, in jax's order: a dict by
    sorted key, a sequence by index, a named tuple by field name."""
    if isinstance(tree, dict):
        return ((str(k), tree[k]) for k in sorted(tree))
    if hasattr(tree, "_fields"):
        return zip(tree._fields, tree)
    return ((str(i), v) for i, v in enumerate(tree))


def _with_paths(tree, prefix: str) -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    if isinstance(tree, (dict, list, tuple)):
        for name, sub in _children(tree):
            yield from _with_paths(sub, f"{prefix}{name}/")
        return
    yield prefix[:-1], tree


def flatten_with_paths(tree) -> Dict[str, Any]:
    """``'a/b/0/c' -> leaf``, for checkpoint serialization: the path names
    of the reference's ``flatten_with_paths`` (a dict key is its key, a
    sequence key its index, a named-tuple field its name, joined by
    ``/``), leaves in jax's order.  ``None`` is no leaf."""
    return dict(_with_paths(tree, ""))


def tree_map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of ``tree``, the paths those of
    :func:`flatten_with_paths`; the structure (named tuples, ``None``) is
    kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, f"{prefix}{name}/")
               for name, v in _children(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(prefix[:-1], tree)
