"""Checkpoint / resume for env fleets and training state.

The port of ``utils/checkpoint.py``: orbax becomes ``torch.save`` and
``torch.load(weights_only=True)``.  Every piece of parallax state is a
tree of tensors (NamedTuple states, dicts of parameters) or plain data
(an optimizer's ``state_dict()``), so one file holds env states, PRNG
keys, policy parameters, the optimizer state and a step counter: save,
restore, continue.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _plain(tree):
    """``tree`` with its NamedTuples as dicts of their fields, which
    ``torch.load(weights_only=True)`` reads back without their classes."""
    if _is_namedtuple(tree):
        return {f: _plain(x) for f, x in zip(tree._fields, tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_plain(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach()
    return tree


def _like(target, data, device):
    """``data`` (as ``_plain`` wrote it) in the structure of ``target``, each
    tensor in its target's dtype and on ``device`` (None: its target's)."""
    if _is_namedtuple(target):
        return type(target)(*(_like(t, data[f], device) for f, t in zip(target._fields, target)))
    if isinstance(target, (tuple, list)):
        return type(target)(_like(t, d, device) for t, d in zip(target, data))
    if isinstance(target, dict):
        return {k: _like(t, data[k], device) for k, t in target.items()}
    if torch.is_tensor(target):
        if tuple(data.shape) != tuple(target.shape):
            raise ValueError(
                f"checkpoint leaf of shape {tuple(data.shape)} does not match the "
                f"target's {tuple(target.shape)}"
            )
        return data.to(device=device or target.device, dtype=target.dtype)
    return data


def save(path: str, tree: Any, force: bool = True) -> None:
    """Save a tree checkpoint to the file ``path`` (its directory is made);
    ``force=False`` refuses to overwrite."""
    path = os.path.abspath(path)
    if os.path.exists(path) and not force:
        raise FileExistsError(f"checkpoint {path} exists (force=False)")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(_plain(tree), path)


def restore(path: str, target: Optional[Any] = None, map_location=None) -> Any:
    """Restore a checkpoint.  ``target`` (an example tree) pins structure,
    dtypes and devices: each tensor lands on the device of its target's
    tensor, or on ``map_location`` where that is given.  Without
    ``target`` the saved tree comes back with NamedTuples as dicts."""
    data = torch.load(os.path.abspath(path), map_location=map_location, weights_only=True)
    if target is None:
        return data
    return _like(target, data, map_location)
