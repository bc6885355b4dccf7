"""2D helpers: the parts of ``parallax_tpu/geometry/math.py`` the port needs.

``order_clockwise`` builds shapes once, when a world is defined, so it
stays in numpy; ``safe_norm`` is the env hooks' norm in torch.  The
per-step geometry lives in ``engine/batched.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def safe_norm(v, dim: int = -1, keepdim: bool = False):
    """L2 norm with a finite gradient at ``v = 0`` (where it returns 0).

    ``sqrt(sum(v * v))`` has a NaN reverse-mode gradient at the origin
    (``inf * 0``); the where-sqrt-where form keeps it 0 there, as the JAX
    package's ``safe_norm`` does."""
    sq = torch.sum(v * v, dim=dim, keepdim=keepdim)
    zero = sq == 0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))


def order_clockwise(vertices):
    """Order ``[..., n, 2]`` vertices by ascending atan2 angle around their
    centroid (a stable argsort, as ``jnp.argsort``)."""
    v = np.asarray(vertices, np.float32)
    rel = v - np.mean(v, axis=-2, keepdims=True, dtype=np.float32)
    angles = np.arctan2(rel[..., 1], rel[..., 0])
    idx = np.argsort(angles, axis=-1, kind="stable")
    return np.take_along_axis(v, idx[..., None], axis=-2)
