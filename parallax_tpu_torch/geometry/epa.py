"""Batched 2D EPA (the torch port of ``geometry/epa.py``).

The reference's edge-buffer EPA: a buffer of ``solver_iterations + 3``
edges seeded from the GJK simplex; per step the closest edge to the
origin, a support point along its normal, and the edge split in two (the
closest edge's slot takes the first half, slot ``i + 3`` the second:
``epa.py:99-128``), with the same breakdown guards (a tiny edge, a
winding-order violation, no progress, a NaN).  The JAX version runs one
pair as a fixed-length scan under ``vmap``; here one call runs a batch
of pairs, the buffer ``[..., E, 2, 2]``, the split a scatter along the
edge axis, and a finished lane freezes all four parts of its state, as
the scan's masked body does; on CPU tensors the loop ends once every
lane has finished (the same result).  ``torch.argmin`` takes the first minimum,
as ``jnp.argmin`` does.

Returns the reference's penetration vector: the displacement from the
closest point on the Minkowski-difference boundary to the origin.
"""

from __future__ import annotations

from typing import Callable

import torch

from parallax_tpu_torch.geometry.gjk import _all_stopped
from parallax_tpu_torch.geometry.math import _clip_c, cross2, fast_normal, safe_norm, safe_normalize

EPA_DEFAULT_ITERATIONS = 48


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _displacement_to_origin(a, b):
    """origin - closest point on segment ab; (inf, inf) for an empty slot
    (both endpoints zero).  ``a``, ``b`` ``[..., 2]``."""
    length = torch.sum((a - b) ** 2, dim=-1)
    t = _dot(-b, a - b) / torch.where(length == 0, 1.0, length)
    t = _clip_c(t, 0.0, 1.0)
    projection = b + t[..., None] * (a - b)
    disp = torch.where((length == 0)[..., None], -a, -projection)
    empty = ((a == 0.0) & (b == 0.0)).all(dim=-1)
    return torch.where(empty[..., None], float("inf"), disp)


def _closest_point_disp(a, b, point):
    """point - closest point on segment ab."""
    length = torch.sum((a - b) ** 2, dim=-1)
    t = _dot(point - b, a - b) / torch.where(length == 0, 1.0, length)
    t = _clip_c(t, 0.0, 1.0)
    projection = b + t[..., None] * (a - b)
    return torch.where((length == 0)[..., None], point - a, point - projection)


def _closest_edge(edges):
    """``(edge [..., 2, 2], index [...])`` of the edge nearest the origin,
    the first of tied ones."""
    disps = _displacement_to_origin(edges[..., 0, :], edges[..., 1, :])
    idx = torch.argmin(torch.sum(disps**2, dim=-1), dim=-1)
    edge = torch.take_along_dim(edges, idx[..., None, None, None], dim=-3)[..., 0, :, :]
    return edge, idx


def epa(
    sup_a: Callable,
    geom_a,
    sup_b: Callable,
    geom_b,
    simplex,
    solver_iterations: int = EPA_DEFAULT_ITERATIONS,
):
    """EPA over a batch of pairs whose GJK simplex ``[..., 3, 2]`` holds the
    origin; ``solver_iterations`` >= 3 sets the step count and the edge
    buffer's size, as in the reference."""
    if solver_iterations < 3:
        raise ValueError("solver_iterations must be >= 3")

    def mink(d):
        return sup_a(geom_a, d) - sup_b(geom_b, -d)

    batch = simplex.shape[:-2]
    n_edges = solver_iterations + 3
    edges = simplex.new_zeros(batch + (n_edges, 2, 2))
    p0, p1, p2 = simplex[..., 0, :], simplex[..., 1, :], simplex[..., 2, :]
    seed = torch.stack([torch.stack([p0, p1], -2), torch.stack([p1, p2], -2),
                        torch.stack([p2, p0], -2)], dim=-3)
    edges = torch.cat([seed, edges[..., 3:, :, :]], dim=-3)
    slots = torch.arange(n_edges, device=simplex.device)
    origin = simplex.new_zeros(2)

    def cond(last_edge, new_point, prev_edge):
        c1 = torch.sum((last_edge[..., 0, :] - last_edge[..., 1, :]) ** 2, dim=-1) > 1e-9
        c2 = cross2(last_edge[..., 0, :], last_edge[..., 1, :]) >= 0
        normal = safe_normalize(fast_normal(prev_edge[..., 0, :] - prev_edge[..., 1, :]))
        d = _dot(new_point, normal)
        edist = safe_norm(_closest_point_disp(prev_edge[..., 0, :], prev_edge[..., 1, :],
                                              origin))
        c4 = (d - edist > 1e-6) | (d <= 0)
        return c4 & ~torch.isnan(last_edge).any(dim=-1).any(dim=-1) & c1 & c2

    best_edge, best_idx = _closest_edge(edges)
    new_point = p2
    prev_edge = edges[..., 0, :, :]
    running = cond(best_edge, new_point, prev_edge)
    for i in range(solver_iterations):
        normal = safe_normalize(fast_normal(best_edge[..., 0, :] - best_edge[..., 1, :]))
        point = mink(normal)
        a = torch.stack([best_edge[..., 0, :], point], dim=-2)
        b = torch.stack([point, best_edge[..., 1, :]], dim=-2)
        at_best = (slots == best_idx[..., None])[..., None, None]
        split = torch.where(at_best, a[..., None, :, :], edges)
        split = torch.where((slots == i + 3)[:, None, None], b[..., None, :, :], split)
        nbe, nbi = _closest_edge(split)
        # a finished lane keeps its state, as the scan's masked body does
        r = running[..., None]
        edges = torch.where(r[..., None, None], split, edges)
        prev_edge = torch.where(r[..., None], best_edge, prev_edge)
        best_edge = torch.where(r[..., None], nbe, best_edge)
        new_point = torch.where(r, point, new_point)
        best_idx = torch.where(running, nbi, best_idx)
        running = running & cond(best_edge, new_point, prev_edge)
        if _all_stopped(running):
            break
    best_edge, _ = _closest_edge(edges)
    return _closest_point_disp(best_edge[..., 0, :], best_edge[..., 1, :], origin)


def compute_penetration_vector_convex(
    sup_a, geom_a, sup_b, geom_b, simplex, solver_iterations: int = EPA_DEFAULT_ITERATIONS
):
    """The reference-named wrapper of :func:`epa`."""
    return epa(sup_a, geom_a, sup_b, geom_b, simplex, solver_iterations)
