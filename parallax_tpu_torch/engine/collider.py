"""Static pair tables, and the per-world collide over them.

Every candidate part pair (excluding static-static and filtered pairs) is
classified by its contact kernel; pairs are grouped per kernel into
contiguous static index vectors, and the groups concatenate into one flat
``[C]`` contact-lane buffer with static body-index vectors.
``build_pair_table`` is pure Python and numpy: the same table as
``parallax_tpu/engine/collider.py``'s, lane for lane.  :func:`collide`
runs every group's contact function of ``geometry/contacts.py`` on
world-frame parts with leading batch axes (``World.detect_contacts``),
under either narrow phase; the batched step's own collide is
``engine.batched.collide_batched``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from parallax_tpu_torch.geometry.contacts import (
    Contact,
    contact_box_box,
    contact_box_polygon_gjk_epa,
    contact_box_polygon_manifold,
    contact_circle_box,
    contact_circle_circle,
    contact_circle_in_box,
    contact_circle_in_polygon,
    contact_circle_polygon,
    contact_circle_polygon_gjk_epa,
    contact_polygon_polygon_gjk_epa,
    contact_polygon_polygon_manifold,
    contact_verts_in_box,
    contact_verts_in_polygon,
)
from parallax_tpu_torch.geometry.shapes import BOX, CIRCLE, POLYGON, Parts, box_corners, edge_mask_for

# AABB broad-phase slack: a true contact always has overlapping AABBs, so a
# small positive margin makes the cull conservative under f32 noise.
BROADPHASE_MARGIN = 1e-6


@dataclasses.dataclass(frozen=True)
class PairGroup:
    """One kernel's worth of part pairs (static)."""

    kernel: str  # cc | cb | bb | cp | bp | pp | area_*
    part_a: tuple  # canonical A-side part indices
    part_b: tuple
    body_a: tuple  # owning bodies (canonical order)
    body_b: tuple

    @property
    def size(self) -> int:
        return len(self.part_a)


# singleton-lane kernels first, manifold (2-lane) kernels last: the solver
# relies on the contiguous interleaved manifold suffix for partner lanes
KERNEL_ORDER = (
    "cc",
    "cb",
    "bb",
    "cp",
    "area_cb",
    "area_pb",
    "area_bb",
    "area_cp",
    "area_pp",
    "area_bp",
    "bp",
    "pp",
)

# kernels that emit a 2-point manifold (two contact lanes per pair)
MANIFOLD_KERNELS = ("bp", "pp")

_KIND_PAIR_TO_KERNEL = {
    (CIRCLE, CIRCLE): "cc",
    (CIRCLE, BOX): "cb",
    (BOX, BOX): "bb",
    (CIRCLE, POLYGON): "cp",
    (BOX, POLYGON): "bp",
    (POLYGON, POLYGON): "pp",
}


@dataclasses.dataclass(frozen=True)
class PairTable:
    """All static pair groups plus flat body-index vectors."""

    groups: tuple  # tuple[PairGroup]
    body_a: tuple  # concatenated over groups, length C
    body_b: tuple
    partner: tuple  # partner lane of a 2-point manifold, or -1

    @property
    def n_contacts(self) -> int:
        return len(self.body_a)


def build_pair_table(
    parts: Parts,
    static_bodies: Sequence[bool],
    area_bodies: Sequence[bool],
    collision_filter: Sequence[tuple] = (),
    narrowphase: str = "sat",
    part_collision_filter: Sequence[tuple] = (),
) -> PairTable:
    """Host-side pair enumeration.

    * static-static pairs are dropped (nothing to resolve);
    * pairs in ``collision_filter`` (unordered body-index tuples) dropped;
    * pairs in ``part_collision_filter`` (unordered part-index tuples)
      dropped;
    * pairs involving an area body produce containment kernels: the
      non-area body must stay inside the area shape;
    * everything else is classified by (kind_a, kind_b) canonical order.
    """
    filt = {tuple(sorted(p)) for p in collision_filter}
    pfilt = {tuple(sorted(p)) for p in part_collision_filter}
    P = parts.n_parts
    buckets: dict = {k: [] for k in KERNEL_ORDER}

    for p in range(P):
        for q in range(p + 1, P):
            bi, bj = parts.body[p], parts.body[q]
            if bi == bj:
                continue
            if tuple(sorted((bi, bj))) in filt:
                continue
            if pfilt and (p, q) in pfilt:
                continue
            if static_bodies[bi] and static_bodies[bj]:
                continue
            ai, aj = area_bodies[bi], area_bodies[bj]
            if ai and aj:
                continue
            ki, kj = parts.kind[p], parts.kind[q]
            if ai or aj:
                # containment: A = contained body, B = area part
                (cp, cb_, cbody, abody) = (q, p, bj, bi) if ai else (p, q, bi, bj)
                ck = parts.kind[cp]
                ak = parts.kind[cb_]
                if ak == BOX:
                    kernel = {CIRCLE: "area_cb", POLYGON: "area_pb", BOX: "area_bb"}[ck]
                elif ak == POLYGON:
                    kernel = {CIRCLE: "area_cp", POLYGON: "area_pp", BOX: "area_bp"}[ck]
                else:
                    raise NotImplementedError(
                        "circle-shaped area parts are not supported; use a "
                        "box or convex-polygon area"
                    )
                buckets[kernel].append((cp, cb_, cbody, abody))
                continue
            if (ki, kj) in _KIND_PAIR_TO_KERNEL:
                kernel = _KIND_PAIR_TO_KERNEL[(ki, kj)]
                buckets[kernel].append((p, q, bi, bj))
            else:
                kernel = _KIND_PAIR_TO_KERNEL[(kj, ki)]
                buckets[kernel].append((q, p, bj, bi))

    groups = []
    body_a_all, body_b_all, partner_all = [], [], []
    manifold_kernels = MANIFOLD_KERNELS if narrowphase == "sat" else ()
    for kernel in KERNEL_ORDER:
        rows = buckets[kernel]
        if not rows:
            continue
        pa, pb, ba, bb_ = zip(*rows)
        groups.append(
            PairGroup(
                kernel=kernel,
                part_a=tuple(pa),
                part_b=tuple(pb),
                body_a=tuple(ba),
                body_b=tuple(bb_),
            )
        )
        if kernel in manifold_kernels:
            # two contact lanes per pair, interleaved (pair, point)
            for x, y in zip(ba, bb_):
                base = len(body_a_all)
                body_a_all.extend((x, x))
                body_b_all.extend((y, y))
                partner_all.extend((base + 1, base))
        else:
            body_a_all.extend(ba)
            body_b_all.extend(bb_)
            partner_all.extend([-1] * len(ba))
    return PairTable(
        groups=tuple(groups),
        body_a=tuple(body_a_all),
        body_b=tuple(body_b_all),
        partner=tuple(partner_all),
    )


def _flatten_manifold(out: Contact) -> Contact:
    """``[..., G, 2]`` manifold contacts -> flat ``[..., 2G]`` lanes (pair 0's
    two points, then pair 1's, ...)."""
    return Contact(
        penetration=out.penetration.flatten(-3, -2),
        point=out.point.flatten(-3, -2),
        active=out.active.flatten(-2, -1),
        weight=out.weight.flatten(-2, -1),
    )


def _edge_masks(parts: Parts, idx) -> torch.Tensor:
    """``[G, V]`` real-edge masks of the parts ``idx``."""
    V = parts.max_verts
    return torch.from_numpy(
        np.stack([edge_mask_for(parts.nverts[i], V) for i in idx])).to(parts.verts.device)


def _poly_aabb(v):
    """``[..., G, V, 2]`` world vertices -> ``(lo, hi)`` ``[..., G, 2]``."""
    return torch.amin(v, dim=-2), torch.amax(v, dim=-2)


def _circle_aabb(c, r):
    return c - r[..., None], c + r[..., None]


def _aabb_overlap(a, b):
    """``(lo, hi)`` pairs -> ``[..., G]`` overlap mask, with the margin."""
    (alo, ahi), (blo, bhi) = a, b
    m = BROADPHASE_MARGIN
    return torch.all((alo <= bhi + m) & (blo <= ahi + m), dim=-1)


def _apply_broadphase(out: Contact, ov, manifold: bool) -> Contact:
    """AND an AABB pre-mask into a group's lanes, zeroing the culled
    penetrations."""
    if manifold:
        ov = torch.repeat_interleave(ov, 2, dim=-1)
    return Contact(
        penetration=out.penetration * ov[..., None],
        point=out.point,
        active=out.active & ov,
        weight=out.weight,
    )


def collide(
    world_parts: Parts,
    table: PairTable,
    narrowphase: str = "sat",
    broadphase: bool = False,
) -> Contact:
    """Every pair group's contact function; returns a flat ``[..., C]``
    contact buffer, lanes in table order.

    ``world_parts`` is in the world frame (``Parts.to_world``), batch axes
    leading.  Under ``"sat"`` the ``bp`` and ``pp`` groups write a 2-point
    manifold (two lanes a pair); under ``"gjk_epa"`` one lane from GJK,
    EPA and the edge-mean point, EPA's step count a group's largest vertex
    counts plus one (``bp``: 4 + the polygon's + 1), at most 48, and
    ``cp``'s 128.  ``broadphase`` ANDs an AABB-overlap pre-mask into the
    ``cp``, ``bp`` and ``pp`` groups (the circle and box functions mask
    themselves)."""
    v = world_parts.verts  # [..., P, V, 2]
    r = world_parts.radius  # [P] or [..., P]
    nverts = world_parts.nverts
    pieces = []
    for g in table.groups:
        ia, ib = list(g.part_a), list(g.part_b)
        va, vb = v[..., ia, :, :], v[..., ib, :, :]
        ra, rb = r[..., ia], r[..., ib]
        ca, la, ua = va[..., 0, :], va[..., 0, :], va[..., 1, :]
        cb_, lb, ub = vb[..., 0, :], vb[..., 0, :], vb[..., 1, :]
        if g.kernel == "cc":
            out = contact_circle_circle(ca, ra, cb_, rb)
        elif g.kernel == "cb":
            out = contact_circle_box(ca, ra, lb, ub)
        elif g.kernel == "bb":
            out = contact_box_box(la, ua, lb, ub)
        elif g.kernel == "cp":
            emb = _edge_masks(world_parts, ib)
            if narrowphase == "gjk_epa":
                out = contact_circle_polygon_gjk_epa(ca, ra, vb, emb, 128)
            else:
                out = contact_circle_polygon(ca, ra, vb, emb)
            if broadphase:
                ov = _aabb_overlap(_circle_aabb(ca, ra), _poly_aabb(vb))
                out = _apply_broadphase(out, ov, manifold=False)
        elif g.kernel == "bp":
            emb = _edge_masks(world_parts, ib)
            if narrowphase == "gjk_epa":
                iters = min(48, 4 + max(nverts[i] for i in ib) + 1)
                out = contact_box_polygon_gjk_epa(la, ua, vb, emb, iters)
            else:
                out = _flatten_manifold(contact_box_polygon_manifold(la, ua, vb, emb))
            if broadphase:
                ov = _aabb_overlap((la, ua), _poly_aabb(vb))
                out = _apply_broadphase(out, ov, manifold=narrowphase != "gjk_epa")
        elif g.kernel == "pp":
            ema = _edge_masks(world_parts, ia)
            emb = _edge_masks(world_parts, ib)
            if narrowphase == "gjk_epa":
                iters = min(48, max(nverts[i] for i in ia) + max(nverts[i] for i in ib) + 1)
                out = contact_polygon_polygon_gjk_epa(va, ema, vb, emb, iters)
            else:
                out = _flatten_manifold(contact_polygon_polygon_manifold(va, ema, vb, emb))
            if broadphase:
                ov = _aabb_overlap(_poly_aabb(va), _poly_aabb(vb))
                out = _apply_broadphase(out, ov, manifold=narrowphase != "gjk_epa")
        elif g.kernel == "area_cb":
            out = contact_circle_in_box(ca, ra, lb, ub)
        elif g.kernel == "area_pb":
            out = contact_verts_in_box(va, lb, ub)
        elif g.kernel == "area_bb":
            out = contact_verts_in_box(box_corners(la, ua), lb, ub)
        elif g.kernel == "area_cp":
            out = contact_circle_in_polygon(ca, ra, vb, _edge_masks(world_parts, ib))
        elif g.kernel == "area_pp":
            out = contact_verts_in_polygon(va, vb, _edge_masks(world_parts, ib))
        elif g.kernel == "area_bp":
            out = contact_verts_in_polygon(box_corners(la, ua), vb,
                                           _edge_masks(world_parts, ib))
        else:  # pragma: no cover
            raise ValueError(g.kernel)
        pieces.append(_broadcast(out))

    if not pieces:
        z = v.new_zeros(v.shape[:-3] + (0, 2))
        return Contact(penetration=z, point=z,
                       active=torch.zeros(z.shape[:-1], dtype=torch.bool, device=v.device),
                       weight=v.new_ones(z.shape[:-1]))
    return Contact(
        penetration=torch.cat([p.penetration for p in pieces], dim=-2),
        point=torch.cat([p.point for p in pieces], dim=-2),
        active=torch.cat([p.active for p in pieces], dim=-1),
        weight=torch.cat([p.weight for p in pieces], dim=-1),
    )


def _broadcast(out: Contact) -> Contact:
    """A group's lanes with every field at one batch shape."""
    batch = torch.broadcast_shapes(out.penetration.shape[:-1], out.point.shape[:-1],
                                   out.active.shape, out.weight.shape)
    return Contact(
        penetration=out.penetration.expand(*batch, 2),
        point=out.point.expand(*batch, 2),
        active=out.active.expand(batch),
        weight=out.weight.expand(batch),
    )
