"""Batched, differentiable 2D GJK (the torch port of ``geometry/gjk.py``).

The JAX package's GJK runs one pair under ``vmap``; here one call runs a
batch of pairs, its leading dimensions broadcast from the geometry.  The
iteration is the JAX version's fixed 32 steps with a per-lane ``running``
mask (``gjk.py:85-118``): a Python loop of ``torch.where`` updates, so a
finished lane freezes as the reference's while-loop would stop, and on
CPU tensors the loop ends once every lane has (the same result).  The
seeding, the simplex update, the exit test and the validity and
degeneracy rules (``gjk.py:120-134``) are the JAX version's.

Support functions are passed as ``(fn, geom)`` pairs: ``fn(geom,
direction[..., 2]) -> point[..., 2]``.  The simplex is ``[..., 3, 2]``:
a triangle in Minkowski-difference space that holds the origin when the
pair collides, NaN otherwise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from parallax_tpu_torch.geometry.math import fast_normal, is_point_in_triangle, random_direction

GJK_MAX_STEPS = 32

# random_direction(PRNGKey(1)), the reference's default seed
DEFAULT_INITIAL_DIRECTION = np.array([-0.87677443, 0.48090222], dtype=np.float32)


class GJKResult(NamedTuple):
    colliding: torch.Tensor  # [...] bool
    simplex: torch.Tensor  # [..., 3, 2] (NaN when not colliding)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _all_stopped(running) -> bool:
    """Whether no lane of a CPU batch still runs: the remaining steps of
    GJK's or EPA's loop would leave every lane as it is, so the loop may
    stop there, with the same result.  On the card this would be a host
    sync a step, so it is not asked there."""
    return running.device.type == "cpu" and not bool(running.any())


def _direction(d, geom):
    """``d`` as a tensor of the geometry's dtype and device."""
    probe = geom[0] if isinstance(geom, tuple) else geom
    return torch.as_tensor(d, dtype=probe.dtype, device=probe.device)


def gjk(
    sup_a: Callable,
    geom_a,
    sup_b: Callable,
    geom_b,
    initial_direction=None,
    max_steps: int = GJK_MAX_STEPS,
) -> GJKResult:
    """GJK over a batch of pairs; ``initial_direction`` is ``[2]`` or
    ``[..., 2]`` (default ``DEFAULT_INITIAL_DIRECTION``)."""

    def mink(d):
        return sup_a(geom_a, d) - sup_b(geom_b, -d)

    if initial_direction is None:
        initial_direction = DEFAULT_INITIAL_DIRECTION
    s0 = mink(_direction(initial_direction, geom_a))
    s1 = mink(-s0)

    # arrange clockwise; the direction is the normal toward the origin
    direction = fast_normal(s1 - s0)
    flip = (_dot(direction, -s1) > 0)[..., None]
    s0f, s1f = torch.where(flip, s1, s0), torch.where(flip, s0, s1)
    direction = torch.where(flip, direction, -direction)
    c = mink(direction)
    simplex = torch.stack(torch.broadcast_tensors(s0f, s1f, c), dim=-2)

    def cond(simplex, direction):
        p0, p2 = simplex[..., 0, :], simplex[..., 2, :]
        c1 = _dot(p2, direction) <= 0
        c2 = _dot(fast_normal(p2 - p0), -p2) < 0
        c3 = _dot(fast_normal(simplex[..., 1, :] - p2), -p2) < 0
        return ~(c1 | (c2 & c3))

    direction = direction.expand(simplex.shape[:-2] + (2,))
    running = cond(simplex, direction)
    for _ in range(max_steps):
        a, b, c = simplex[..., 0, :], simplex[..., 1, :], simplex[..., 2, :]
        ac_normal = fast_normal(c - a)
        cb_normal = fast_normal(b - c)
        keep_a = (_dot(ac_normal, -c) >= 0)[..., None]
        new_direction = torch.where(keep_a, ac_normal, cb_normal)
        new_point = mink(new_direction)
        new_simplex = torch.stack([torch.where(keep_a, a, c), torch.where(keep_a, c, b),
                                   new_point], dim=-2)
        # lanes that met the exit test freeze (the while-loop's semantics)
        simplex = torch.where(running[..., None, None], new_simplex, simplex)
        direction = torch.where(running[..., None], new_direction, direction)
        running = running & cond(simplex, direction)
        if _all_stopped(running):
            break

    # validity: the origin inside the triangle
    p0, p1, p2 = simplex[..., 0, :], simplex[..., 1, :], simplex[..., 2, :]
    inside = is_point_in_triangle(torch.zeros_like(p0), p0, p1, p2)
    simplex = torch.where(inside[..., None, None], simplex, torch.zeros_like(simplex))
    # degeneracy rejection
    e1 = simplex[..., 1, :] - simplex[..., 0, :]
    e2 = simplex[..., 2, :] - simplex[..., 0, :]
    area = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    bad = ((simplex == 0).all(dim=-1).all(dim=-1) | torch.isnan(simplex).any(dim=-1).any(dim=-1)
           | (area == 0))
    colliding = ~bad
    simplex = torch.where(colliding[..., None, None], simplex,
                          torch.full_like(simplex, float("nan")))
    return GJKResult(colliding=colliding, simplex=simplex)


def check_for_collision_convex(
    sup_a,
    geom_a,
    sup_b,
    geom_b,
    initial_direction=None,
    key=None,
    max_steps: int = GJK_MAX_STEPS,
) -> GJKResult:
    """The reference-shaped entry point: the initial direction is drawn from
    a threefry ``key`` (``random_direction``; ``DEFAULT_INITIAL_DIRECTION``
    without one), or blended 0.1/0.9 with a caller's ``initial_direction``
    (the draw alone where that holds a NaN)."""
    rnd = _direction(DEFAULT_INITIAL_DIRECTION if key is None else random_direction(key),
                     geom_a)
    if initial_direction is None:
        d0 = rnd
    else:
        initial_direction = _direction(initial_direction, geom_a)
        blend = rnd * 0.1 + initial_direction * 0.9
        d0 = torch.where(torch.isnan(initial_direction).any(dim=-1, keepdim=True), rnd, blend)
    return gjk(sup_a, geom_a, sup_b, geom_b, d0, max_steps=max_steps)
