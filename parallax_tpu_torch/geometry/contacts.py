"""Contact functions (the torch port of ``geometry/contacts.py``).

Each function runs a batch of pairs: its arguments carry leading batch
dimensions that broadcast (the JAX package runs one pair and ``vmap``s
it).  Each returns a :class:`Contact`.  The conventions are the JAX
package's:

* ``penetration`` points from body B toward body A, its length the depth:
  moving A by it separates the shapes;
* ``point`` is one representative contact point;
* an inactive contact is ``active=False``; ``Contact.isnan()`` gives the
  reference's NaN-sentinel view.

The analytic circle and box functions are the reference's formulas; the
polygon functions run SAT and reference-face clipping (the ``"sat"``
narrow phase) or GJK, EPA and the reference's edge-mean point (the
``*_gjk_epa`` functions, the ``"gjk_epa"`` narrow phase).  Every
selection follows the JAX function: ``argmin``/``argmax`` take the first
of tied elements, ``amin``/``amax`` split a tie's cotangent evenly, and a
maximum or clip against a constant splits it half and half (as
``jnp.maximum`` and ``jnp.clip`` do; ``torch.clamp`` would pass it all).
"""

from __future__ import annotations

import dataclasses

import torch

from parallax_tpu_torch.geometry.epa import epa as _epa
from parallax_tpu_torch.geometry.gjk import gjk as _gjk
from parallax_tpu_torch.geometry.math import _clip_c, _max_c, _min_c, safe_norm, safe_normalize
from parallax_tpu_torch.geometry.shapes import (
    box_corners,
    contains_circle,
    contains_polygon,
    polygon_edges,
    support_box,
    support_circle,
    support_polygon,
)


@dataclasses.dataclass(frozen=True)
class Contact:
    penetration: torch.Tensor  # [..., 2], B -> A, |pen| = depth
    point: torch.Tensor  # [..., 2]
    active: torch.Tensor  # [...] bool
    weight: torch.Tensor  # [...] impulse scale (a manifold's points share a pair's)

    def isnan(self):
        return ~self.active

    def invert(self):
        """The contact seen from the other body: the penetration flipped."""
        return self.replace(penetration=-self.penetration)

    def replace(self, **kw) -> "Contact":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def none(dtype=torch.float32, device=None):
        return Contact(
            penetration=torch.zeros((2,), dtype=dtype, device=device),
            point=torch.zeros((2,), dtype=dtype, device=device),
            active=torch.zeros((), dtype=torch.bool, device=device),
            weight=torch.ones((), dtype=dtype, device=device),
        )

    @staticmethod
    def single(penetration, point, active):
        """One full-weight contact."""
        return Contact(
            penetration=penetration,
            point=point,
            active=active,
            weight=torch.ones(active.shape, dtype=penetration.dtype, device=active.device),
        )


def _c(x, value):
    """A constant table beside ``x``: its dtype and device."""
    return torch.as_tensor(value, dtype=x.dtype, device=x.device)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _take(x, idx):
    """``x[..., idx, :]`` per batch element: ``x`` ``[..., K, D]``, ``idx``
    ``[...]``."""
    x = x.expand(*idx.shape, *x.shape[-2:])
    return torch.take_along_dim(x, idx[..., None, None], dim=-2)[..., 0, :]


def _take1(x, idx):
    """``x[..., idx]`` per batch element: ``x`` ``[..., K]``."""
    x = x.expand(*idx.shape, x.shape[-1])
    return torch.take_along_dim(x, idx[..., None], dim=-1)[..., 0]


def _safe_unit(v):
    return safe_normalize(v, fallback=_c(v, [1.0, 0.0]))


def _roll(verts):
    return torch.roll(verts, shifts=-1, dims=-2)


# ---------------------------------------------------------------------------
# analytic kernels: the reference formulas
# ---------------------------------------------------------------------------


def contact_circle_circle(ca, ra, cb, rb) -> Contact:
    """Circle against circle, with the reference's same-side-centre
    fallback."""
    delta = ca - cb
    dist = safe_norm(delta)[..., None]
    direction = torch.where(dist == 0.0, _c(delta, [1.0, 0.0]),
                            delta / torch.where(dist == 0.0, 1.0, dist))
    pen_raw = direction * _min_c(dist - (ra + rb)[..., None], 0.0)
    point = (cb + direction * (rb - ra)[..., None] + ca) / 2.0
    # the centres must lie on opposite sides of the contact point; else the
    # contained centre
    same_side = _dot(ca - point, cb - point) > 0
    fallback = torch.where(contains_circle(ca, ra, cb)[..., None], cb, ca)
    point = torch.where(same_side[..., None], fallback, point)
    active = dist[..., 0] <= ra + rb
    return Contact.single(-pen_raw, point, active)


def contact_box_box(la, ua, lb, ub, eps=1e-8) -> Contact:
    """Box against box: the smallest of the four axis depths."""
    separated = ((ua[..., 1] <= lb[..., 1]) | (la[..., 1] >= ub[..., 1])
                 | (ua[..., 0] <= lb[..., 0]) | (la[..., 0] >= ub[..., 0]))
    depths = torch.stack([
        _max_c(ua[..., 1] - lb[..., 1], -eps),
        _max_c(ub[..., 1] - la[..., 1], -eps),
        _max_c(ua[..., 0] - lb[..., 0], -eps),
        _max_c(ub[..., 0] - la[..., 0], -eps),
    ], dim=-1)
    dirs = _c(depths, [[0.0, -1.0], [0.0, 1.0], [-1.0, 0.0], [1.0, 0.0]])
    idx = torch.argmin(depths, dim=-1)
    min_depth = _max_c(_take1(depths, idx), 0.0)
    pen = min_depth[..., None] * dirs[idx]
    point = (torch.minimum(ua, ub) + torch.maximum(la, lb)) / 2.0
    return Contact.single(pen, point, ~separated)


def contact_circle_box(c, r, lb, ub, eps=1e-6) -> Contact:
    """Circle against box: the clamp-to-box closest point; a vertex contact
    moves along the diagonal, a face contact along the best axis."""
    ccp = torch.minimum(torch.maximum(c, lb), ub)  # jnp.clip(c, lb, ub)
    corners = box_corners(lb, ub)
    perfect_vertex = torch.any(
        torch.linalg.vector_norm(corners - ccp[..., None, :], dim=-1) < eps, dim=-1)
    pen_vertex = -(c + r[..., None] * _safe_unit(ccp - c) - ccp)
    shifts = torch.stack([
        c[..., 1] + r - lb[..., 1],
        ub[..., 1] - (c[..., 1] - r),
        c[..., 0] + r - lb[..., 0],
        ub[..., 0] - (c[..., 0] - r),
    ], dim=-1)
    dirs = _c(shifts, [[0.0, 1.0], [0.0, -1.0], [1.0, 0.0], [-1.0, 0.0]])
    best = torch.argmin(shifts, dim=-1)
    pen_face = -_take1(shifts, best)[..., None] * dirs[best]
    pen = torch.where(perfect_vertex[..., None], pen_vertex, pen_face)
    return Contact.single(pen, ccp, contains_circle(c, r, ccp, eps=eps))


def contact_circle_polygon(c, r, verts, edge_mask) -> Contact:
    """Circle against polygon in closed form.  ``verts`` ``[..., V, 2]``
    world-frame, ``edge_mask`` ``[..., V]`` the real edges (edge k runs
    from vertex k to vertex k+1 mod V)."""
    e = _roll(verts) - verts
    elen2 = torch.sum(e**2, dim=-1)
    rel = c[..., None, :] - verts
    t = _clip_c(torch.sum(rel * e, dim=-1) / torch.where(elen2 == 0, 1.0, elen2), 0.0, 1.0)
    proj = verts + t[..., None] * e
    d2 = torch.sum((c[..., None, :] - proj) ** 2, dim=-1)
    d2 = torch.where(edge_mask, d2, float("inf"))
    j = torch.argmin(d2, dim=-1)
    proj_j = _take(proj, j)
    d2j = _take1(d2, j)
    dist = torch.where(d2j == 0, 0.0, torch.sqrt(torch.where(d2j == 0, 1.0, d2j)))
    inside = contains_polygon(verts, edge_mask, c)
    # shallow: the centre outside, the boundary within r
    pen_out = _safe_unit(c - proj_j) * (r - dist)[..., None]
    # deep: the centre inside, pushed along the nearest edge's outward normal
    n_out = torch.stack([e[..., 1], -e[..., 0]], dim=-1)
    n_out = n_out / torch.sqrt(torch.where(elen2 == 0, 1.0, elen2))[..., None]
    signed = torch.where(edge_mask, torch.sum(rel * n_out, dim=-1), -float("inf"))
    k = torch.argmax(signed, dim=-1)
    pen_in = _take(n_out, k) * (r - _take1(signed, k))[..., None]
    pen = torch.where(inside[..., None], pen_in, pen_out)
    point = torch.where(inside[..., None], c, proj_j)
    active = inside | (dist <= r)
    pen = torch.where(active[..., None], pen, torch.zeros_like(pen))
    return Contact.single(pen, point, active)


# ---------------------------------------------------------------------------
# polygon against polygon: SAT and clipping
# ---------------------------------------------------------------------------


def _sat_axes(verts, edge_mask):
    """Unit outward normals of the real edges; padded axes masked out."""
    e = _roll(verts) - verts
    n = torch.stack([e[..., 1], -e[..., 0]], dim=-1)
    ln = safe_norm(n)
    n = n / torch.where(ln == 0, 1.0, ln)[..., None]
    return n, edge_mask & (ln > 0)


def _project(verts, axes):
    """``verts @ axes.T``: ``[..., V, A]`` projections, each a sum of two
    products."""
    return (verts[..., :, None, 0] * axes[..., None, :, 0]
            + verts[..., :, None, 1] * axes[..., None, :, 1])


def _pair(va, vb, ema, emb):
    """The two polygons and masks broadcast to one batch shape."""
    batch = torch.broadcast_shapes(va.shape[:-2], vb.shape[:-2], ema.shape[:-1],
                                   emb.shape[:-1])
    return (va.expand(*batch, *va.shape[-2:]), vb.expand(*batch, *vb.shape[-2:]),
            ema.expand(*batch, ema.shape[-1]), emb.expand(*batch, emb.shape[-1]))


def contact_polygon_polygon(va, ema, vb, emb) -> Contact:
    """Single-point polygon contact: the manifold's weighted mean point and
    its deepest lane's penetration."""
    m = contact_polygon_polygon_manifold(va, ema, vb, emb)
    w = m.weight * m.active.to(m.weight.dtype)
    wsum = torch.sum(w, dim=-1)
    point = torch.sum(m.point * w[..., None], dim=-2) / torch.where(wsum == 0, 1.0, wsum)[..., None]
    point = torch.where((wsum == 0)[..., None], (m.point[..., 0, :] + m.point[..., 1, :]) / 2,
                        point)
    deepest = torch.argmax(torch.sum(m.penetration**2, dim=-1), dim=-1)
    pen = _take(m.penetration, deepest)
    return Contact.single(pen, point, torch.any(m.active, dim=-1))


def contact_polygon_polygon_manifold(va, ema, vb, emb) -> Contact:
    """SAT minimal-translation vector and a 2-point clipped manifold: the
    fields carry a trailing manifold axis of 2 (two clipped points whose
    weights sum to 1 on a face contact)."""
    va, vb, ema, emb = _pair(va, vb, ema, emb)
    na, va_ok = _sat_axes(va, ema)
    nb, vb_ok = _sat_axes(vb, emb)
    axes = torch.cat([na, nb], dim=-2)
    ok = torch.cat([va_ok, vb_ok], dim=-1)
    pa, pb = _project(va, axes), _project(vb, axes)
    min_a, max_a = torch.amin(pa, dim=-2), torch.amax(pa, dim=-2)
    min_b, max_b = torch.amin(pb, dim=-2), torch.amax(pb, dim=-2)
    # the push-out distances along +axis and -axis
    o_pos = max_b - min_a
    o_neg = max_a - min_b
    overlap_m = torch.where(ok, torch.minimum(o_pos, o_neg), float("inf"))
    active = torch.amin(overlap_m, dim=-1) >= 0
    idx = torch.argmin(overlap_m, dim=-1)
    axis = _take(axes, idx)
    depth = _max_c(_take1(overlap_m, idx), 0.0)
    sign = torch.where(_take1(o_pos, idx) <= _take1(o_neg, idx), 1.0, -1.0)
    pen = axis * (depth * sign)[..., None]
    n_ba = axis * sign[..., None]
    points, lane_depth = _clip_contact_points(va, ema, vb, emb, n_ba)
    # keep clip points within a depth tolerance of the face
    keep_tol = _max_c(depth, 1e-4)
    kept = lane_depth >= -keep_tol[..., None]
    kf = kept.to(points.dtype)
    wsum = torch.sum(kf, dim=-1)[..., None]
    wnorm = kf / torch.where(wsum == 0, 1.0, wsum)
    wnorm = torch.where(wsum == 0, _c(points, [1.0, 0.0]), wnorm)
    first = torch.tensor([True, False], device=kept.device)
    lane_active = active[..., None] & torch.where(wsum == 0, first, kept)
    lane_pen = n_ba[..., None, :] * _max_c(lane_depth, 1e-6)[..., None]
    lane_pen = torch.where(wsum[..., None] == 0, pen[..., None, :], lane_pen)
    lane_pen = torch.where(lane_active[..., None], lane_pen, 0.0)
    return Contact(penetration=lane_pen, point=points, active=lane_active, weight=wnorm)


def _incident_edge(verts, edge_mask, ref_normal):
    """The endpoints of the edge whose outward normal is most anti-parallel
    to ``ref_normal``."""
    nxt = _roll(verts)
    e = nxt - verts
    n = torch.stack([e[..., 1], -e[..., 0]], dim=-1)
    n = n / _max_c(safe_norm(n, keepdim=True), 1e-12)
    d = torch.where(edge_mask, torch.sum(n * ref_normal[..., None, :], dim=-1), float("inf"))
    k = torch.argmin(d, dim=-1)
    return _take(verts, k), _take(nxt, k)


def _clip_contact_points(va, ema, vb, emb, n_ba):
    """Box2D-style reference-face clipping: two points and their depths
    past the reference face."""
    na, va_ok = _sat_axes(va, ema)
    nb, vb_ok = _sat_axes(vb, emb)
    align_a = torch.where(va_ok, torch.sum(na * (-n_ba)[..., None, :], dim=-1), -float("inf"))
    align_b = torch.where(vb_ok, torch.sum(nb * n_ba[..., None, :], dim=-1), -float("inf"))
    ka = torch.argmax(align_a, dim=-1)
    kb = torch.argmax(align_b, dim=-1)
    ref_is_a = (_take1(align_a, ka) >= _take1(align_b, kb))[..., None]
    r0 = torch.where(ref_is_a, _take(va, ka), _take(vb, kb))
    r1 = torch.where(ref_is_a, _take(_roll(va), ka), _take(_roll(vb), kb))
    n_ref = torch.where(ref_is_a, -n_ba, n_ba)
    ia, ib_ = _incident_edge(va, ema, n_ba)  # where B owns the reference
    ja, jb_ = _incident_edge(vb, emb, -n_ba)  # where A owns it
    i0 = torch.where(ref_is_a, ja, ia)
    i1 = torch.where(ref_is_a, jb_, ib_)
    t = r1 - r0
    t = t / _max_c(safe_norm(t), 1e-12)[..., None]

    def clip(p0, p1, anchor, direction):
        """The part of segment [p0, p1] with dot(p - anchor, dir) >= 0."""
        d0 = _dot(p0 - anchor, direction)[..., None]
        d1 = _dot(p1 - anchor, direction)[..., None]
        frac = d0 / torch.where(d0 - d1 == 0, 1.0, d0 - d1)
        inter = p0 + frac * (p1 - p0)
        q0 = torch.where(d0 < 0, torch.where(d1 >= 0, inter, p0), p0)
        q1 = torch.where(d1 < 0, torch.where(d0 >= 0, inter, p1), p1)
        return q0, q1

    c0, c1 = clip(i0, i1, r0, t)
    c0, c1 = clip(c0, c1, r1, -t)
    d0 = -_dot(c0 - r0, n_ref)
    d1 = -_dot(c1 - r0, n_ref)
    return torch.stack([c0, c1], dim=-2), torch.stack([d0, d1], dim=-1)


def _box_as_polygon(lb_box, ub_box):
    """The box's 4 corners in the polygons' edge-normal order, and its
    edge mask."""
    vb4 = torch.flip(box_corners(lb_box, ub_box), dims=[-2])
    return vb4, torch.ones((4,), dtype=torch.bool, device=vb4.device)


def contact_box_polygon(lb_box, ub_box, vp, emp) -> Contact:
    """Box as its 4-corner polygon, then SAT."""
    vb4, em4 = _box_as_polygon(lb_box, ub_box)
    return contact_polygon_polygon(vb4, em4, vp, emp)


def contact_box_polygon_manifold(lb_box, ub_box, vp, emp) -> Contact:
    vb4, em4 = _box_as_polygon(lb_box, ub_box)
    return contact_polygon_polygon_manifold(vb4, em4, vp, emp)


# ---------------------------------------------------------------------------
# containment ("area") contacts: keep a body inside an area body
# ---------------------------------------------------------------------------

_WALLS = [[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0], [0.0, -1.0]]


def contact_circle_in_box(c, r, lb, ub) -> Contact:
    """Circle (body A) escaping an axis-aligned box area (body B); the
    penetration pushes it back inside."""
    over_hi = (c + r[..., None]) - ub
    over_lo = lb - (c - r[..., None])
    esc_hi = _max_c(over_hi, 0.0)
    esc_lo = _max_c(over_lo, 0.0)
    pen = -esc_hi + esc_lo
    depth = torch.maximum(torch.amax(esc_hi, dim=-1), torch.amax(esc_lo, dim=-1))
    active = depth > 0
    k = torch.argmax(torch.cat([over_hi, over_lo], dim=-1), dim=-1)
    point = c + _c(c, _WALLS)[k] * r[..., None]
    pen = torch.where(active[..., None], pen, torch.zeros_like(pen))
    return Contact.single(pen, point, active)


def contact_verts_in_box(verts, lb, ub) -> Contact:
    """A polygon (or a box's corners) escaping an axis-aligned box area; the
    contact point is the extreme vertex on the deepest wall."""
    over_hi = torch.amax(verts, dim=-2) - ub
    over_lo = lb - torch.amin(verts, dim=-2)
    esc_hi = _max_c(over_hi, 0.0)
    esc_lo = _max_c(over_lo, 0.0)
    pen = -esc_hi + esc_lo
    depth = torch.maximum(torch.amax(esc_hi, dim=-1), torch.amax(esc_lo, dim=-1))
    active = depth > 0
    idx4 = torch.stack([torch.argmax(verts[..., 0], dim=-1), torch.argmax(verts[..., 1], dim=-1),
                        torch.argmin(verts[..., 0], dim=-1), torch.argmin(verts[..., 1], dim=-1)],
                       dim=-1)
    k = torch.argmax(torch.cat([over_hi, over_lo], dim=-1), dim=-1)
    point = _take(verts, _take1(idx4, k))
    pen = torch.where(active[..., None], pen, torch.zeros_like(pen))
    return Contact.single(pen, point, active)


def _poly_inward_normals(verts, edge_mask):
    """Unit inward edge normals of a convex area polygon, and the real
    edges."""
    e = _roll(verts) - verts
    elen2 = torch.sum(e**2, dim=-1)
    n_in = torch.stack([-e[..., 1], e[..., 0]], dim=-1)
    n_in = n_in / torch.sqrt(torch.where(elen2 == 0, 1.0, elen2))[..., None]
    return n_in, edge_mask & (elen2 > 0)


def contact_circle_in_polygon(c, r, verts, edge_mask) -> Contact:
    """Circle escaping a convex polygon area: its centre keeps an inward
    distance of at least r from every edge line."""
    n_in, valid = _poly_inward_normals(verts, edge_mask)
    d_in = torch.sum((c[..., None, :] - verts) * n_in, dim=-1)
    viol = torch.where(valid, r[..., None] - d_in, -float("inf"))
    k = torch.argmax(viol, dim=-1)
    depth = _take1(viol, k)
    nk = _take(n_in, k)
    pen = nk * _max_c(depth, 0.0)[..., None]
    return Contact.single(pen, c - nk * r[..., None], depth > 0)


def contact_verts_in_polygon(verts_a, area_verts, area_edge_mask) -> Contact:
    """A polygon escaping a convex polygon area: the deepest outside vertex
    anchors the contact, the most violated edge's inward normal pushes."""
    n_in, valid = _poly_inward_normals(area_verts, area_edge_mask)
    rel = verts_a[..., :, None, :] - area_verts[..., None, :, :]
    d_in = torch.sum(rel * n_in[..., None, :, :], dim=-1)  # [..., Va, Ve]
    viol = torch.where(valid[..., None, :], -d_in, -float("inf"))
    per_vertex = torch.amax(viol, dim=-1)
    v = torch.argmax(per_vertex, dim=-1)
    k = torch.argmax(_take(viol, v), dim=-1)
    depth = _take1(per_vertex, v)
    pen = _take(n_in, k) * _max_c(depth, 0.0)[..., None]
    return Contact.single(pen, _take(verts_a, v), depth > 0)


# ---------------------------------------------------------------------------
# the reference's narrow phase: GJK, EPA and the edge-mean contact point
# (narrowphase="gjk_epa")
# ---------------------------------------------------------------------------


def _sup_poly(geom, d):
    return support_polygon(geom, d)


def _sup_circle(geom, d):
    c, r = geom
    return support_circle(c, r, d)


def _sup_box(geom, d):
    lo, hi = geom
    return support_box(lo, hi, d)


def _segment_intersections(va, vb):
    """All edge-edge intersection points of two padded polygons:
    ``([..., Va * Vb, 2] points, [..., Va * Vb] valid)``."""
    p, ra = polygon_edges(va)
    q, rb = polygon_edges(vb)
    r = ra - p
    s = rb - q
    c = r[..., :, None, 0] * s[..., None, :, 1] - r[..., :, None, 1] * s[..., None, :, 0]
    qp = q[..., None, :, :] - p[..., :, None, :]
    crs_qp_s = qp[..., 0] * s[..., None, :, 1] - qp[..., 1] * s[..., None, :, 0]
    crs_qp_r = qp[..., 0] * r[..., :, None, 1] - qp[..., 1] * r[..., :, None, 0]
    safe_c = torch.where(c == 0, 1.0, c)
    t = crs_qp_s / safe_c
    u = crs_qp_r / safe_c
    valid = (c != 0) & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts = p[..., :, None, :] + t[..., None] * r[..., :, None, :]
    return pts.flatten(-3, -2), valid.flatten(-2, -1)


def contact_point_edges_mean(va, ema, vb, emb):
    """The mean of the edge-edge intersections, the vertices of A inside B
    and those of B inside A: ``(point, any found)``."""
    va, vb, ema, emb = _pair(va, vb, ema, emb)
    pts, valid = _segment_intersections(va, vb)
    valid = valid & (ema[..., :, None] & emb[..., None, :]).flatten(-2, -1)
    in_b = contains_polygon(vb[..., None, :, :], emb[..., None, :], va)
    in_a = contains_polygon(va[..., None, :, :], ema[..., None, :], vb)
    cand = torch.cat([pts, va, vb], dim=-2)
    w = torch.cat([valid, in_b, in_a], dim=-1).to(va.dtype)
    wsum = torch.sum(w, dim=-1)
    mean = torch.sum(cand * w[..., None], dim=-2) / torch.where(wsum == 0, 1.0, wsum)[..., None]
    return mean, wsum > 0


def _finish(pen, active):
    pen = torch.where(active[..., None], pen, torch.zeros_like(pen))
    return torch.where(torch.isnan(pen), 0.0, pen)


def contact_polygon_polygon_gjk_epa(va, ema, vb, emb, solver_iterations=48) -> Contact:
    """The reference's polygon against polygon: GJK, EPA, edge-mean point."""
    va, vb, ema, emb = _pair(va, vb, ema, emb)
    res = _gjk(_sup_poly, va, _sup_poly, vb)
    pen = _epa(_sup_poly, va, _sup_poly, vb, res.simplex, solver_iterations)
    point, found = contact_point_edges_mean(va, ema, vb, emb)
    active = res.colliding & found
    point = torch.where(found[..., None], point, (va[..., 0, :] + vb[..., 0, :]) / 2)
    return Contact.single(_finish(pen, active), point, active)


def contact_box_polygon_gjk_epa(lb_box, ub_box, vp, emp, solver_iterations=48) -> Contact:
    """The reference's box against polygon."""
    res = _gjk(_sup_box, (lb_box, ub_box), _sup_poly, vp)
    pen = _epa(_sup_box, (lb_box, ub_box), _sup_poly, vp, res.simplex, solver_iterations)
    vb4, em4 = _box_as_polygon(lb_box, ub_box)
    point, found = contact_point_edges_mean(vb4, em4, vp, emp)
    active = res.colliding & found
    point = torch.where(found[..., None], point, (vb4[..., 0, :] + vp[..., 0, :]) / 2)
    return Contact.single(_finish(pen, active), point, active)


def contact_circle_polygon_gjk_epa(c, r, verts, edge_mask, solver_iterations=128) -> Contact:
    """The reference's circle against polygon: GJK, 128-step EPA, and its
    closest-edge contact point (its literal ``c + (c - proj)`` arithmetic
    kept for trajectory parity)."""
    res = _gjk(_sup_circle, (c, r), _sup_poly, verts)
    pen = _epa(_sup_circle, (c, r), _sup_poly, verts, res.simplex, solver_iterations)
    e = _roll(verts) - verts
    elen2 = torch.sum(e**2, dim=-1)
    t = torch.sum((c[..., None, :] - verts) * e, dim=-1) / torch.where(elen2 == 0, 1.0, elen2)
    t = _clip_c(t, 0.0, 1.0)
    disp = c[..., None, :] - (verts + t[..., None] * e)
    d2 = torch.where(edge_mask, torch.sum(disp**2, dim=-1), float("inf"))
    j = torch.argmin(d2, dim=-1)
    far = (_take1(d2, j) > r**2)[..., None]
    point = torch.where(far, c, c + _take(disp, j))
    return Contact.single(_finish(pen, res.colliding), point, res.colliding)
