"""Tree helpers over NamedTuples, tuples, lists and dicts of tensors.

The port of ``utils/pytree.py``: ``tree_stack``/``tree_unstack``
(list-of-structs to struct-of-arrays and back), ``tree_select`` (the
in-graph auto-reset's select), ``tree_get``/``tree_set`` (indexed gather
and scatter over every leaf) and ``tree_zeros_like``.  The port's states
are NamedTuples, so the Flax struct idioms ``static_field`` and ``frozen``
have no counterpart here.
"""

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


def tree_stack(trees, axis: int = 0):
    """Stack a sequence of trees of one structure into one tree of stacked
    leaves (struct-of-arrays)."""
    return tree_map(lambda *xs: torch.stack(xs, dim=axis), *trees)


def tree_unstack(tree, axis: int = 0) -> list:
    """Inverse of :func:`tree_stack`: one tree for each index along
    ``axis``."""
    n = tree_leaves(tree)[0].shape[axis]
    return [tree_map(lambda x: x.select(axis, i), tree) for i in range(n)]


def tree_get(tree, idx):
    """Gather ``leaf[idx]`` for every leaf."""
    return tree_map(lambda x: x[idx], tree)


def tree_set(tree, idx, value):
    """``leaf[idx] = value_leaf`` for every leaf, on copies: the input tree
    is left as it was (JAX's ``x.at[idx].set(v)``)."""

    def put(x, v):
        y = x.clone()
        y[idx] = v
        return y

    return tree_map(put, tree, value)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)
