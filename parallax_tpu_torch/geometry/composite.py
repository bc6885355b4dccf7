"""Composite (multi-part) shape queries over part tables (the torch port of
``geometry/composite.py``, the reference's ``UniversalShape`` API).

A composite is a :class:`Parts` table in the world frame
(``Parts.to_world``), possibly a concave union of convex parts, with
leading batch axes allowed:

* ``support``: the farthest of the parts' supports;
* ``collides_with``: GJK over every part pair;
* ``penetrates_with``: the deepest EPA penetration over the colliding pairs;
* ``possibly_collides_with``: the AABB broad phase.
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.geometry.epa import epa
from parallax_tpu_torch.geometry.gjk import gjk
from parallax_tpu_torch.geometry.shapes import Parts, support_any


def _part_geom(parts: Parts, i: int):
    return parts.kind[i], (parts.verts[..., i, :, :], parts.radius[..., i])


def _sup(kind):
    def f(geom, d):
        verts, radius = geom
        return support_any(kind, verts, radius, d)

    return f


def support(parts: Parts, direction, part_indices=None):
    """The composite's farthest point along ``direction`` (the first part
    wins a tie)."""
    idx = range(parts.n_parts) if part_indices is None else part_indices
    best_p = best_d = None
    for i in idx:
        kind, geom = _part_geom(parts, i)
        p = _sup(kind)(geom, direction)
        d = torch.sum(p * direction, dim=-1)
        if best_p is None:
            best_p, best_d = p, d
        else:
            better = d > best_d
            best_p = torch.where(better[..., None], p, best_p)
            best_d = torch.maximum(d, best_d)
    return best_p


def collides_with(parts_a: Parts, parts_b: Parts, key=None, details: bool = False):
    """Whether any part of A overlaps any part of B (GJK per pair).

    ``key`` is accepted as the JAX package accepts it, which seeds every
    pair from ``gjk.DEFAULT_INITIAL_DIRECTION`` all the same.  With
    ``details=True`` returns ``(hit, (simplex, part_a, part_b))``: the GJK
    simplex and the part indices of the first colliding pair; where
    nothing collides, the last pair's simplex and indices -1."""
    del key
    dev = parts_a.verts.device
    hit = simplex = None
    pa = pb = torch.tensor(-1, dtype=torch.int32, device=dev)
    for i in range(parts_a.n_parts):
        ka, ga = _part_geom(parts_a, i)
        for j in range(parts_b.n_parts):
            kb, gb = _part_geom(parts_b, j)
            res = gjk(_sup(ka), ga, _sup(kb), gb)
            if hit is None:
                hit = torch.zeros_like(res.colliding)
            take = res.colliding & ~hit  # the first colliding pair wins
            simplex = (res.simplex if simplex is None
                       else torch.where(take[..., None, None], res.simplex, simplex))
            pa = torch.where(take, i, pa).to(torch.int32)
            pb = torch.where(take, j, pb).to(torch.int32)
            hit = hit | res.colliding
    if details:
        return hit, (simplex, pa, pb)
    return hit


def penetrates_with(parts_a: Parts, parts_b: Parts, solver_iterations: int = 48):
    """``(colliding, penetration)``: the deepest part pair's EPA vector, which
    moves A so that the composites separate."""
    best_pen = best_d = any_hit = None
    for i in range(parts_a.n_parts):
        ka, ga = _part_geom(parts_a, i)
        for j in range(parts_b.n_parts):
            kb, gb = _part_geom(parts_b, j)
            res = gjk(_sup(ka), ga, _sup(kb), gb)
            pen = epa(_sup(ka), ga, _sup(kb), gb, res.simplex, solver_iterations)
            pen = torch.where(res.colliding[..., None], pen, torch.zeros_like(pen))
            d = torch.sum(pen**2, dim=-1)
            if best_pen is None:
                best_pen = torch.zeros_like(pen)
                best_d = torch.full_like(d, -float("inf"))
                any_hit = torch.zeros_like(res.colliding)
            take = res.colliding & (d > best_d)
            best_pen = torch.where(take[..., None], pen, best_pen)
            best_d = torch.where(take, d, best_d)
            any_hit = any_hit | res.colliding
    return any_hit, best_pen


def possibly_collides_with(parts_a: Parts, parts_b: Parts, margin=0.0):
    """The AABB broad phase over the composites' extents."""
    lo_a, hi_a = parts_a.extents()
    lo_b, hi_b = parts_b.extents()
    lo_a, hi_a = torch.amin(lo_a, dim=-2), torch.amax(hi_a, dim=-2)
    lo_b, hi_b = torch.amin(lo_b, dim=-2), torch.amax(hi_b, dim=-2)
    return torch.all((hi_a + margin >= lo_b) & (hi_b + margin >= lo_a), dim=-1)
