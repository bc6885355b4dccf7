"""Core 2D geometry helpers (the torch port of ``geometry/math.py``).

Every function takes tensors with arbitrary leading batch axes and is
branchless, as the JAX package's are.  Rigid transforms are carried as
``(position, cos, sin)`` (:class:`Transform2`).  ``order_clockwise``
builds shapes once, when a world is defined, so it stays in numpy.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

__all__ = [
    "fast_normal",
    "perpendicular_vector",
    "cross2",
    "rotate",
    "random_direction",
    "order_clockwise",
    "is_point_in_triangle",
    "angle_between",
    "safe_norm",
    "safe_normalize",
    "Transform2",
]


@functools.lru_cache(maxsize=None)
def _const(c: float, dtype: torch.dtype) -> torch.Tensor:
    """``c`` as a 0-dim CPU tensor, made once: a CUDA op takes it as a scalar."""
    return torch.tensor(c, dtype=dtype)


def _max_c(x, c: float):
    """``jnp.maximum(x, c)`` against a constant: the value and NaN of
    ``torch.clamp(x, min=c)``, but a tie splits the cotangent half and half,
    as in JAX (``torch.clamp`` passes all of it)."""
    return torch.maximum(x, _const(c, x.dtype))


def _min_c(x, c: float):
    """``jnp.minimum(x, c)`` against a constant; see :func:`_max_c`."""
    return torch.minimum(x, _const(c, x.dtype))


def _clip_c(x, lo: float, hi: float):
    """``jnp.clip(x, lo, hi)`` against constants; see :func:`_max_c`."""
    return _min_c(_max_c(x, lo), hi)


def safe_norm(v, dim: int = -1, keepdim: bool = False):
    """L2 norm with a finite gradient at ``v = 0`` (where it returns 0).

    ``sqrt(sum(v * v))`` has a NaN reverse-mode gradient at the origin
    (``inf * 0``); the where-sqrt-where form keeps it 0 there, as the JAX
    package's ``safe_norm`` does."""
    sq = torch.sum(v * v, dim=dim, keepdim=keepdim)
    zero = sq == 0
    return torch.where(zero, 0.0, torch.sqrt(torch.where(zero, 1.0, sq)))


def safe_normalize(v, dim: int = -1, fallback=None):
    """``v / |v|`` with finite gradients at 0; ``fallback`` (or the zero
    vector) where ``|v| = 0``."""
    n = safe_norm(v, dim=dim, keepdim=True)
    zero = n == 0
    out = v / torch.where(zero, 1.0, n)
    if fallback is not None:
        out = torch.where(zero, torch.as_tensor(fallback, dtype=v.dtype, device=v.device), out)
    return out


def fast_normal(a):
    """90 degrees counter-clockwise: ``(x, y) -> (-y, x)`` over ``[..., 2]``."""
    return torch.stack([-a[..., 1], a[..., 0]], dim=-1)


perpendicular_vector = fast_normal


def cross2(a, b):
    """Scalar z-component of the 2D cross product over ``[..., 2]``."""
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def rotate(v, angle):
    """Rotate ``[..., 2]`` vectors by ``[...]`` angles (radians), CCW."""
    c, s = torch.cos(angle), torch.sin(angle)
    x, y = v[..., 0], v[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def random_direction(key):
    """A uniform random unit vector from a threefry key ``[..., 2]`` (int64
    holding uint32 values, ``utils.prng``): ``jax.random.normal(key, (2,))``
    normalized, so a key draws the JAX package's direction (within float32
    ulps, ``utils.prng.normal``).  ``None`` gives ``(1, 0)``."""
    if key is None:
        return torch.tensor([1.0, 0.0], dtype=torch.float32)
    from parallax_tpu_torch.utils import prng

    x = prng.normal(key, (2,))
    return x / torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def order_clockwise(vertices):
    """Order ``[..., n, 2]`` vertices by ascending atan2 angle around their
    centroid (a stable argsort, as ``jnp.argsort``)."""
    v = np.asarray(vertices, np.float32)
    rel = v - np.mean(v, axis=-2, keepdims=True, dtype=np.float32)
    angles = np.arctan2(rel[..., 1], rel[..., 0])
    idx = np.argsort(angles, axis=-1, kind="stable")
    return np.take_along_axis(v, idx[..., None], axis=-2)


def is_point_in_triangle(pt, v1, v2, v3):
    """Sign-of-area containment test over ``[..., 2]`` points."""

    def sign(p1, p2, p3):
        return (p1[..., 0] - p3[..., 0]) * (p2[..., 1] - p3[..., 1]) - (
            p2[..., 0] - p3[..., 0]
        ) * (p1[..., 1] - p3[..., 1])

    d1 = sign(pt, v1, v2)
    d2 = sign(pt, v2, v3)
    d3 = sign(pt, v3, v1)
    has_neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
    has_pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
    return ~(has_neg & has_pos)


def angle_between(v1, v2):
    """Unsigned angle between two ``[..., 2]`` vectors."""
    v1u = v1 / torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    v2u = v2 / torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    d = torch.sum(v1u * v2u, dim=-1)
    return torch.arccos(_clip_c(d, -1.0, 1.0))


@dataclasses.dataclass(frozen=True)
class Transform2:
    """Rigid 2D transform stored as ``(position, cos, sin)``, arbitrary
    leading batch axes; its inverse is the transposed rotation."""

    position: torch.Tensor  # [..., 2]
    cos: torch.Tensor  # [...]
    sin: torch.Tensor  # [...]

    @classmethod
    def make(cls, position=None, angle=None) -> "Transform2":
        if position is None:
            position = torch.zeros(2, dtype=torch.float32)
        if angle is None:
            angle = torch.zeros(position.shape[:-1], dtype=position.dtype,
                                device=position.device)
        return cls(position=position, cos=torch.cos(angle), sin=torch.sin(angle))

    @classmethod
    def identity(cls, batch_shape=(), device=None) -> "Transform2":
        return cls(
            position=torch.zeros(tuple(batch_shape) + (2,), dtype=torch.float32, device=device),
            cos=torch.ones(tuple(batch_shape), dtype=torch.float32, device=device),
            sin=torch.zeros(tuple(batch_shape), dtype=torch.float32, device=device),
        )

    def _rot(self, v, inverse=False):
        c, s = self.cos, (-self.sin if inverse else self.sin)
        x, y = v[..., 0], v[..., 1]
        return torch.stack([c * x - s * y, s * x + c * y], dim=-1)

    def forward_direction(self, d):
        """Direction local -> global (rotation only)."""
        return self._rot(d)

    def inverse_direction(self, d):
        """Direction global -> local."""
        return self._rot(d, inverse=True)

    def forward_vector(self, p):
        """Point local -> global."""
        return self._rot(p) + self.position

    def inverse_vector(self, p):
        """Point global -> local."""
        return self._rot(p - self.position, inverse=True)

    def shift(self):
        return self.position

    @property
    def angle(self):
        return torch.arctan2(self.sin, self.cos)
