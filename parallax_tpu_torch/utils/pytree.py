"""Minimal tree helpers over NamedTuples, tuples, lists and dicts of tensors."""

from __future__ import annotations

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of the same structure.  ``None``
    stays ``None``; any other non-container value is a leaf."""
    if tree is None:
        return None
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map`` order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_select(pred, on_true, on_false):
    """``torch.where(pred, on_true, on_false)`` over every leaf: ``pred``
    is a bool tensor of the trees' batch shape (or a scalar), given one
    trailing dim for each dim a leaf has beyond it (the JAX package's
    ``tree_select``, the in-graph auto-reset's select)."""

    def sel(t, f):
        p = pred
        extra = max(t.ndim, f.ndim) - p.ndim
        if extra > 0:
            p = p.reshape(p.shape + (1,) * extra)
        return torch.where(p, t, f)

    return tree_map(sel, on_true, on_false)
