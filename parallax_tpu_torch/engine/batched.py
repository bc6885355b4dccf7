"""Batch-minor physics step in torch: integrate, collide, solve, joints.

The port of ``parallax_tpu/engine/batched.py``.  The layouts stay the JAX
package's, batch axis minor:

* body state      -> per-component ``[n, B]`` planes (``_SoA``)
* world vertices  -> ``[G, V, B]`` x/y planes per pair group
* contact lanes   -> ``[C, B]`` planes (``ContactsBM``)

Small argmin/argmax selections stay static Python loops of running
``where``-selects, with the JAX package's tie and NaN semantics.  The
contact solve with the joints runs as the CUDA kernel of
``ops/contact_solver.py`` when ``WorldConfig.use_cuda_solver`` is set; its
plain torch version is :func:`solve_contacts_bm` + :func:`apply_joints_bm`.
With ``WorldConfig.use_cuda_fused`` the whole step runs as the fused
kernel of ``ops/fused_step.py`` instead (it takes precedence), and under
autograd its reverse-pass kernel is the backward; its plain version is
this module's split step.  Neither falls back: on CUDA tensors a world the
fused kernel does not run raises.

Pair groups: every kind of the JAX package's pair table.  ``pp`` and
``bp`` (a box as a 4-corner polygon) take the SAT manifold, two lanes a
pair; ``cc``, ``cb``, ``bb``, ``cp`` and the six containment kinds
``area_*`` one analytic lane a pair.

Public entry: :func:`step_batched`, the batched world step over ``[B, n,
...]`` states (the JAX package's drop-in for ``jax.vmap(world.step)``);
plane-space rollouts loop over :func:`physics_core`.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from parallax_tpu_torch.dynamics.bodies import BodyState
from parallax_tpu_torch.dynamics.impulses import ContactSolverConfig
from parallax_tpu_torch.engine.collider import BROADPHASE_MARGIN
from parallax_tpu_torch.geometry.math import _clip_c, _const, _max_c, _min_c  # noqa: F401
from parallax_tpu_torch.geometry.shapes import CIRCLE, POLYGON, edge_mask_for
from parallax_tpu_torch.utils.profiling import named

INF = float("inf")

# Recompute the split step's narrow phase in the backward pass instead of
# keeping its intermediates (the JAX package's switch of the same name).
# Read at import: set it before the port is imported.
_REMAT_COLLIDE = os.environ.get("PARALLAX_REMAT_COLLIDE", "0") != "0"


class ContactsBM(NamedTuple):
    """Batch-minor contact buffer: all fields ``[C, B]``."""

    pen_x: torch.Tensor
    pen_y: torch.Tensor
    pt_x: torch.Tensor
    pt_y: torch.Tensor
    active: torch.Tensor  # bool
    weight: torch.Tensor


class _SoA(NamedTuple):
    """Batch-minor body state: all fields ``[n, B]``."""

    px: torch.Tensor
    py: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    angle: torch.Tensor
    omega: torch.Tensor


def _to_soa(state: BodyState) -> _SoA:
    def t(x):  # [B, n] -> contiguous [n, B]
        return x.transpose(0, 1).contiguous()

    return _SoA(
        px=t(state.pos[..., 0]),
        py=t(state.pos[..., 1]),
        vx=t(state.vel[..., 0]),
        vy=t(state.vel[..., 1]),
        angle=t(state.angle),
        omega=t(state.omega),
    )


def _from_soa(s: _SoA) -> BodyState:
    return BodyState(
        pos=torch.stack([s.px.T, s.py.T], dim=-1),
        vel=torch.stack([s.vx.T, s.vy.T], dim=-1),
        angle=s.angle.T.contiguous(),
        omega=s.omega.T.contiguous(),
    )


def _rsqrt_safe(x):
    return torch.rsqrt(torch.where(x <= 0, 1.0, x))


# ---------------------------------------------------------------------------
# static device tables, built once per world (World.build)
# ---------------------------------------------------------------------------


class _SideTable(NamedTuple):
    body: torch.Tensor  # [G] long: owning body of each part
    lx: torch.Tensor  # [G, V, 1] local vertices
    ly: torch.Tensor
    rotate: torch.Tensor  # [G, 1, 1] bool: polygon or circle part


class _SolverIndex(NamedTuple):
    ia: torch.Tensor  # [C] long
    ib: torch.Tensor
    ip: torch.Tensor  # [C] partner lane (self where none)
    iab: torch.Tensor  # [2C] ia then ib
    has_p: torch.Tensor  # [C, 1] bool
    is_lead: torch.Tensor  # [C, 1] bool
    movable: torch.Tensor  # [n, 1] bool


def _side_table(world, part_idx, vn: int) -> _SideTable:
    def build():
        dev = world.device
        idx = list(part_idx)
        lv = world.parts.verts[idx][:, :vn]  # [G, vn, 2]
        kinds = [world.parts.kind[i] for i in idx]
        rot = np.asarray([k == POLYGON or k == CIRCLE for k in kinds])
        return _SideTable(
            body=torch.tensor([world.parts.body[i] for i in idx], device=dev),
            lx=lv[..., 0][:, :, None].contiguous(),
            ly=lv[..., 1][:, :, None].contiguous(),
            rotate=torch.from_numpy(rot)[:, None, None].to(dev),
        )

    return world.static(("side", tuple(part_idx), vn), build)


def _group_rows(world, g):
    """The vertex rows each side of a group reads and their ``[G, V]`` edge
    masks (JAX ``engine/batched.py:639-647``): a polygon's repeat-padded rows
    up to the group's largest vertex count, a circle's centre, a box's
    ``lb`` and ``ub``.  A ``bp`` pair's box enters the SAT as a 4-corner
    polygon, so its mask is four real edges."""

    def build():
        Va = max(world.parts.nverts[i] for i in g.part_a)
        Vb = max(world.parts.nverts[i] for i in g.part_b)
        if g.kernel in _ANALYTIC:
            Va, Vb = min(Va, 2), min(Vb, 2)
        elif g.kernel in ("area_cp", "area_bp"):
            Va = min(Va, 2)  # the contained circle's centre, box's lb and ub
        if g.kernel == "bp":
            ema = np.stack([edge_mask_for(4, 4)] * g.size)
        else:
            ema = np.stack([edge_mask_for(world.parts.nverts[i], Va) for i in g.part_a])
        emb = np.stack([edge_mask_for(world.parts.nverts[i], Vb) for i in g.part_b])
        return (
            Va, Vb,
            torch.from_numpy(ema).to(world.device),
            torch.from_numpy(emb).to(world.device),
        )

    return world.static(("group", g), build)


def _radii(world, g):
    """``[G, 1]`` radius columns of a group's two sides."""

    def build():
        r = world.parts.radius
        ia = torch.tensor(g.part_a, device=r.device)
        ib = torch.tensor(g.part_b, device=r.device)
        return r[ia][:, None].contiguous(), r[ib][:, None].contiguous()

    return world.static(("radii", g), build)


def _solver_index(world) -> _SolverIndex:
    def build():
        dev = world.device
        table = world.table
        C = table.n_contacts
        ia = np.asarray(table.body_a, np.int64)
        ib = np.asarray(table.body_b, np.int64)
        partner = np.asarray(table.partner, np.int64)
        has_p = partner >= 0
        ip = np.where(has_p, partner, np.arange(C))
        is_lead = has_p & (partner > np.arange(C))
        movable = np.asarray([not st for st in world.static_bodies])

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return _SolverIndex(
            ia=t(ia), ib=t(ib), ip=t(ip), iab=t(np.concatenate([ia, ib])),
            has_p=t(has_p)[:, None], is_lead=t(is_lead)[:, None],
            movable=t(movable)[:, None],
        )

    return world.static(("solver_index",), build)


def build_static_tables(world) -> None:
    """Move every static table of the batched step to the world's device."""
    if world.config.narrowphase != "sat" or world.config.solver_mode != "block":
        return  # the batched step refuses such worlds (check_batched_support)
    for g in world.table.groups:
        Va, Vb, _, _ = _group_rows(world, g)
        _radii(world, g)
        _side_table(world, g.part_a, Va)
        _side_table(world, g.part_b, Vb)
    if world.table.n_contacts:
        _solver_index(world)
    if world.config.use_cuda_solver or world.config.use_cuda_fused:
        from parallax_tpu_torch.ops.contact_solver import solver_operands

        solver_operands(world, world.config.contact)
    if world.config.use_cuda_fused:
        from parallax_tpu_torch.ops.fused_step import fused_operands

        fused_operands(world)


def _side_verts(world, s: _SoA, part_idx, vn: int, override_verts=None):
    """World-frame x/y vertex planes ``[G, vn, B]`` for the given parts.

    ``override_verts`` replaces the parts' local vertices with per-world
    batch-minor planes (a ``([G, vn, B] x, [G, vn, B] y)`` tuple).
    """
    t = _side_table(world, part_idx, vn)
    c = torch.cos(s.angle)[t.body][:, None, :]  # [G, 1, B]
    sn = torch.sin(s.angle)[t.body][:, None, :]
    px = s.px[t.body][:, None, :]
    py = s.py[t.body][:, None, :]
    lx, ly = (t.lx, t.ly) if override_verts is None else override_verts
    wx = torch.where(t.rotate, c * lx - sn * ly, lx) + px
    wy = torch.where(t.rotate, sn * lx + c * ly, ly) + py
    return wx, wy


# ---------------------------------------------------------------------------
# batch-minor polygon-polygon manifold (SAT + reference-face clip)
# ---------------------------------------------------------------------------


def _edge_axes(wx, wy, em):
    """Unit outward edge normals: (nx, ny [G, V, B], ok [G, V, B])."""
    ex = torch.roll(wx, -1, dims=1) - wx
    ey = torch.roll(wy, -1, dims=1) - wy
    nx, ny = ey, -ex
    ln2 = nx * nx + ny * ny
    inv = _rsqrt_safe(ln2)
    ok = em[:, :, None] & (ln2 > 0)
    return nx * inv, ny * inv, ok


def _minmax_proj(nx, ny, wx, wy):
    """min/max over vertices of projections onto each axis: ``[G, A, B]``."""
    mn = mx = None
    for v in range(wx.shape[1]):
        p = nx * wx[:, v : v + 1, :] + ny * wy[:, v : v + 1, :]
        mn = p if mn is None else torch.minimum(mn, p)
        mx = p if mx is None else torch.maximum(mx, p)
    return mn, mx


def _pp_manifold_bm(ax, ay, ema, bx, by, emb, inactive_without_axis=False):
    """Batch-minor polygon-polygon manifold.

    Inputs ``[G, V, B]`` vertex planes + ``[G, V]`` bool edge masks.
    Returns per-pair 2-lane manifold planes: pen/pt ``[G, 2, B]`` x/y,
    active/weight ``[G, 2, B]``.  A pair with no valid axis (a world with
    NaN vertices) is active with infinite depth, as in the JAX split path,
    or inactive with ``inactive_without_axis``, as in the fused step
    (``pallas_step.py:251``).
    """
    G, Va, B = ax.shape
    Vb = bx.shape[1]
    nax, nay, aok = _edge_axes(ax, ay, ema)
    nbx, nby, bok = _edge_axes(bx, by, emb)
    NX = torch.cat([nax, nbx], dim=1)  # [G, Va+Vb, B]
    NY = torch.cat([nay, nby], dim=1)
    OK = torch.cat([aok, bok], dim=1)

    mna, mxa = _minmax_proj(NX, NY, ax, ay)
    mnb, mxb = _minmax_proj(NX, NY, bx, by)
    o_pos = mxb - mna  # push A along +axis
    o_neg = mxa - mnb  # push A along -axis
    ovl = torch.where(OK, torch.minimum(o_pos, o_neg), INF)
    sign = torch.where(o_pos <= o_neg, 1.0, -1.0)

    # best axis via running select (first minimum wins, NaN never taken)
    best = ax.new_full((G, B), INF)
    bx_ax = ax.new_zeros((G, B))
    by_ax = ax.new_zeros((G, B))
    bsign = ax.new_ones((G, B))
    for a in range(Va + Vb):
        o = ovl[:, a, :]
        take = o < best
        best = torch.where(take, o, best)
        bx_ax = torch.where(take, NX[:, a, :], bx_ax)
        by_ax = torch.where(take, NY[:, a, :], by_ax)
        bsign = torch.where(take, sign[:, a, :], bsign)
    active = best >= 0
    if inactive_without_axis:
        active = active & (best < INF)
    depth = _max_c(best, 0.0)
    n_x = bx_ax * bsign  # MTV direction B -> A
    n_y = by_ax * bsign

    # ---- reference face: best-aligned outward normal per polygon --------
    def best_edge(nx_, ny_, ok_, wx_, wy_, dx, dy):
        """argmax over edges of dot(normal, (dx,dy)) -> endpoints + score."""
        bestv = ax.new_full((G, B), -INF)
        r0x = r0y = r1x = r1y = ax.new_zeros((G, B))
        wnx = torch.roll(wx_, -1, dims=1)
        wny = torch.roll(wy_, -1, dims=1)
        for v in range(wx_.shape[1]):
            al = nx_[:, v, :] * dx + ny_[:, v, :] * dy
            al = torch.where(ok_[:, v, :], al, -INF)
            take = al > bestv
            bestv = torch.where(take, al, bestv)
            r0x = torch.where(take, wx_[:, v, :], r0x)
            r0y = torch.where(take, wy_[:, v, :], r0y)
            r1x = torch.where(take, wnx[:, v, :], r1x)
            r1y = torch.where(take, wny[:, v, :], r1y)
        return bestv, r0x, r0y, r1x, r1y

    al_a, ar0x, ar0y, ar1x, ar1y = best_edge(nax, nay, aok, ax, ay, -n_x, -n_y)
    al_b, br0x, br0y, br1x, br1y = best_edge(nbx, nby, bok, bx, by, n_x, n_y)
    ref_is_a = al_a >= al_b
    r0x = torch.where(ref_is_a, ar0x, br0x)
    r0y = torch.where(ref_is_a, ar0y, br0y)
    r1x = torch.where(ref_is_a, ar1x, br1x)
    r1y = torch.where(ref_is_a, ar1y, br1y)
    nrefx = torch.where(ref_is_a, -n_x, n_x)
    nrefy = torch.where(ref_is_a, -n_y, n_y)

    # incident edge on the other polygon: its best-aligned edge along its
    # own outward direction (the candidate reference edge not chosen)
    i0x = torch.where(ref_is_a, br0x, ar0x)
    i0y = torch.where(ref_is_a, br0y, ar0y)
    i1x = torch.where(ref_is_a, br1x, ar1x)
    i1y = torch.where(ref_is_a, br1y, ar1y)

    # clip against the reference face's side planes
    tx, ty = r1x - r0x, r1y - r0y
    tl = _rsqrt_safe(tx * tx + ty * ty)
    tx, ty = tx * tl, ty * tl

    def clip(p0x, p0y, p1x, p1y, anx, any_, dx, dy):
        d0 = (p0x - anx) * dx + (p0y - any_) * dy
        d1 = (p1x - anx) * dx + (p1y - any_) * dy
        denom = d0 - d1
        frac = d0 / torch.where(denom == 0, 1.0, denom)
        inx = p0x + frac * (p1x - p0x)
        iny = p0y + frac * (p1y - p0y)
        cut0 = (d0 < 0) & (d1 >= 0)
        cut1 = (d1 < 0) & (d0 >= 0)
        q0x = torch.where(cut0, inx, p0x)
        q0y = torch.where(cut0, iny, p0y)
        q1x = torch.where(cut1, inx, p1x)
        q1y = torch.where(cut1, iny, p1y)
        return q0x, q0y, q1x, q1y

    c0x, c0y, c1x, c1y = clip(i0x, i0y, i1x, i1y, r0x, r0y, tx, ty)
    c0x, c0y, c1x, c1y = clip(c0x, c0y, c1x, c1y, r1x, r1y, -tx, -ty)

    d0 = -((c0x - r0x) * nrefx + (c0y - r0y) * nrefy)
    d1 = -((c1x - r0x) * nrefx + (c1y - r0y) * nrefy)

    keep_tol = _max_c(depth, 1e-4)
    k0 = d0 >= -keep_tol
    k1 = d1 >= -keep_tol
    f0 = k0.to(ax.dtype)
    f1 = k1.to(ax.dtype)
    wsum = f0 + f1
    none_kept = wsum == 0
    safe_wsum = torch.where(none_kept, 1.0, wsum)
    w0 = torch.where(none_kept, 1.0, f0 / safe_wsum)
    w1 = torch.where(none_kept, 0.0, f1 / safe_wsum)
    a0 = active & (none_kept | k0)
    a1 = active & ~none_kept & k1
    ld0 = torch.where(none_kept, depth, _max_c(d0, 1e-6))
    ld1 = torch.where(none_kept, depth, _max_c(d1, 1e-6))

    pen_x = torch.stack([n_x * ld0 * a0, n_x * ld1 * a1], dim=1)  # [G, 2, B]
    pen_y = torch.stack([n_y * ld0 * a0, n_y * ld1 * a1], dim=1)
    pt_x = torch.stack([c0x, c1x], dim=1)
    pt_y = torch.stack([c0y, c1y], dim=1)
    act = torch.stack([a0, a1], dim=1)
    wgt = torch.stack([w0, w1], dim=1)
    return pen_x, pen_y, pt_x, pt_y, act, wgt


# ---------------------------------------------------------------------------
# batch-minor analytic kernels (circle and box families): all [G, B] planes
# ---------------------------------------------------------------------------


def _cc_bm(cax, cay, ra, cbx, cby, rb):
    """Circle-circle lane: penetration along the centre line, depth
    ``max(ra + rb - dist, 0)``, contact point between the surfaces (or at
    the inner centre when one circle holds the other's centre)."""
    dx, dy = cax - cbx, cay - cby
    d2 = dx * dx + dy * dy
    inv = _rsqrt_safe(d2)
    dist = d2 * inv  # |d| (0 when coincident)
    ux = torch.where(d2 == 0, 1.0, dx * inv)
    uy = torch.where(d2 == 0, 0.0, dy * inv)
    rsum = ra + rb
    depth = _max_c(rsum - dist, 0.0)
    active = dist <= rsum
    pen_x, pen_y = ux * depth, uy * depth
    ptx = (cbx + ux * (rb - ra) + cax) / 2
    pty = (cby + uy * (rb - ra) + cay) / 2
    same_side = (cax - ptx) * (cbx - ptx) + (cay - pty) * (cby - pty) > 0
    ex, ey = cbx - cax, cby - cay
    rin = ra + 1e-6
    b_in_a = ex * ex + ey * ey <= rin * rin
    fx = torch.where(b_in_a, cbx, cax)
    fy = torch.where(b_in_a, cby, cay)
    ptx = torch.where(same_side, fx, ptx)
    pty = torch.where(same_side, fy, pty)
    return pen_x * active, pen_y * active, ptx, pty, active


def _cb_bm(cx, cy, r, lbx, lby, ubx, uby, eps=1e-6):
    """Circle-box lane: the centre clamped into the box; a corner contact
    pushes along the corner's direction, a face contact along the face of
    least shift (ties: the earliest of bottom, top, left, right wins)."""
    # jnp.clip(cx, lbx, ubx), with its half-and-half cotangent at a tie
    ccx = torch.minimum(torch.maximum(cx, lbx), ubx)
    ccy = torch.minimum(torch.maximum(cy, lby), uby)
    # perfect-vertex test: the closest point is (numerically) a corner
    at_x = (torch.abs(ccx - lbx) < eps) | (torch.abs(ccx - ubx) < eps)
    at_y = (torch.abs(ccy - lby) < eps) | (torch.abs(ccy - uby) < eps)
    perfect_vertex = at_x & at_y
    dvx, dvy = ccx - cx, ccy - cy
    dd = dvx * dvx + dvy * dvy
    inv = _rsqrt_safe(dd)
    uvx = torch.where(dd == 0, 1.0, dvx * inv)
    uvy = torch.where(dd == 0, 0.0, dvy * inv)
    pvx = -(cx + r * uvx - ccx)
    pvy = -(cy + r * uvy - ccy)
    # face case: the best single-axis shift
    s0 = cy + r - lby
    s1 = uby - (cy - r)
    s2 = cx + r - lbx
    s3 = ubx - (cx - r)
    best = torch.minimum(torch.minimum(s0, s1), torch.minimum(s2, s3))
    # the tie order of argmin([s0, s1, s2, s3]): the earliest wins
    is0 = best == s0
    is1 = ~is0 & (best == s1)
    is2 = ~is0 & ~is1 & (best == s2)
    is3 = ~is0 & ~is1 & ~is2
    pfx = torch.where(is2, -s2, torch.where(is3, s3, 0.0))
    pfy = torch.where(is0, -s0, torch.where(is1, s1, 0.0))
    pen_x = torch.where(perfect_vertex, pvx, pfx)
    pen_y = torch.where(perfect_vertex, pvy, pfy)
    ox, oy = cx - ccx, cy - ccy
    reps = r + eps
    active = ox * ox + oy * oy <= reps * reps
    return pen_x * active, pen_y * active, ccx, ccy, active


def _area_cb_bm(cx, cy, r, lbx, lby, ubx, uby):
    """Circle held inside an area box: the push back by how far the circle
    pokes past each side (``max(., 0)`` of each, half the cotangent to each
    side at a tie), and the contact point on the circle at the side it
    pokes furthest past (ties: the earliest of right, top, left, bottom)."""
    over_hx = _max_c(cx + r - ubx, 0.0)
    over_hy = _max_c(cy + r - uby, 0.0)
    over_lx = _max_c(lbx - (cx - r), 0.0)
    over_ly = _max_c(lby - (cy - r), 0.0)
    pen_x = -over_hx + over_lx
    pen_y = -over_hy + over_ly
    depth = torch.maximum(torch.maximum(over_hx, over_hy), torch.maximum(over_lx, over_ly))
    active = depth > 0
    # the deepest wall's surface point: a selection, it takes no cotangent
    dhx = cx + r - ubx
    dhy = cy + r - uby
    dlx = lbx - (cx - r)
    dly = lby - (cy - r)
    best = torch.maximum(torch.maximum(dhx, dhy), torch.maximum(dlx, dly))
    is_hx = best == dhx
    is_hy = ~is_hx & (best == dhy)
    is_lx = ~is_hx & ~is_hy & (best == dlx)
    ptx = torch.where(is_hx, cx + r, torch.where(is_hy, cx, torch.where(is_lx, cx - r, cx)))
    pty = torch.where(is_hx, cy, torch.where(is_hy, cy + r, torch.where(is_lx, cy, cy - r)))
    return pen_x * active, pen_y * active, ptx, pty, active


def _bb_bm(lax_, lay, uax, uay, lbx, lby, ubx, uby, eps=1e-8):
    """Box-box lane: the axis of least overlap (ties: the earliest of A's top
    into B's bottom, B's top into A's bottom, A's right into B's left, B's
    right into A's left), pushed by that overlap, at the middle of the
    overlap; touching boxes are separated.  Every min and max of the lane,
    the ``-eps`` floors and the clip of the depth included, splits a tie's
    cotangent half and half, as in JAX."""
    separated = (uay <= lby) | (lay >= uby) | (uax <= lbx) | (lax_ >= ubx)
    d0 = _max_c(uay - lby, -eps)
    d1 = _max_c(uby - lay, -eps)
    d2 = _max_c(uax - lbx, -eps)
    d3 = _max_c(ubx - lax_, -eps)
    best = torch.minimum(torch.minimum(d0, d1), torch.minimum(d2, d3))
    is0 = best == d0
    is1 = ~is0 & (best == d1)
    is2 = ~is0 & ~is1 & (best == d2)
    is3 = ~is0 & ~is1 & ~is2
    m = _max_c(best, 0.0)
    pen_x = torch.where(is2, -m, torch.where(is3, m, 0.0))
    pen_y = torch.where(is0, -m, torch.where(is1, m, 0.0))
    ptx = (torch.minimum(uax, ubx) + torch.maximum(lax_, lbx)) / 2
    pty = (torch.minimum(uay, uby) + torch.maximum(lay, lby)) / 2
    active = ~separated
    return pen_x * active, pen_y * active, ptx, pty, active


def _cp_bm(cx, cy, r, vx, vy, em):
    """Circle-polygon lane on ``[G, V, B]`` polygon planes: outside, the push
    from the nearest edge point (first nearest wins); with the centre inside
    every real edge, the push out through the edge of largest signed
    distance (first largest wins)."""
    G, V, B = vx.shape
    em3 = em[:, :, None]
    nx_e = torch.roll(vx, -1, dims=1) - vx
    ny_e = torch.roll(vy, -1, dims=1) - vy
    el2 = nx_e * nx_e + ny_e * ny_e
    inv_el2 = 1.0 / torch.where(el2 == 0, 1.0, el2)
    # each edge's closest point to the centre
    ox, oy = cx[:, None, :] - vx, cy[:, None, :] - vy
    tx = _clip_c((ox * nx_e + oy * ny_e) * inv_el2, 0.0, 1.0)
    prx = vx + tx * nx_e
    pry = vy + tx * ny_e
    dx = cx[:, None, :] - prx
    dy = cy[:, None, :] - pry
    d2 = torch.where(em3, dx * dx + dy * dy, INF)
    best = vx.new_full((G, B), INF)
    bpx = bpy = vx.new_zeros((G, B))
    for v in range(V):
        take = d2[:, v, :] < best
        best = torch.where(take, d2[:, v, :], best)
        bpx = torch.where(take, prx[:, v, :], bpx)
        bpy = torch.where(take, pry[:, v, :], bpy)
    inv_d = _rsqrt_safe(best)
    dist = best * inv_d
    # outward normals (CCW order)
    onx = ny_e * _rsqrt_safe(el2)
    ony = -nx_e * _rsqrt_safe(el2)
    signed = torch.where(em3, ox * onx + oy * ony, -INF)
    # contained: every real edge's signed distance <= 0 (or every >= 0)
    inside = ((signed >= 0) | ~em3).all(1) | ((signed <= 0) | ~em3).all(1)
    bs = vx.new_full((G, B), -INF)
    bnx = bny = vx.new_zeros((G, B))
    for v in range(V):
        take = signed[:, v, :] > bs
        bs = torch.where(take, signed[:, v, :], bs)
        bnx = torch.where(take, onx[:, v, :], bnx)
        bny = torch.where(take, ony[:, v, :], bny)
    ux = torch.where(best == 0, 1.0, (cx - bpx) * inv_d)
    uy = torch.where(best == 0, 0.0, (cy - bpy) * inv_d)
    pen_x = torch.where(inside, bnx * (r - bs), ux * (r - dist))
    pen_y = torch.where(inside, bny * (r - bs), uy * (r - dist))
    ptx = torch.where(inside, cx, bpx)
    pty = torch.where(inside, cy, bpy)
    active = inside | (dist <= r)
    return pen_x * active, pen_y * active, ptx, pty, active


def _area_vb_bm(vxa, vya, lbx, lby, ubx, uby):
    """Vertices ``[G, V, B]`` held inside an area box: the push back by how
    far they poke past each side, and the contact at the vertex that pokes
    furthest past the side of largest excess (sides: the earliest of right,
    top, left, bottom; vertices: the first extreme one).  The extents are
    ``amax``/``amin``, which split a tie's cotangent evenly over the tied
    rows, as JAX's ``max``/``min`` do (``Tensor.max(dim)`` would not)."""
    hix, hiy = vxa.amax(1), vya.amax(1)
    lox, loy = vxa.amin(1), vya.amin(1)
    dhx, dhy = hix - ubx, hiy - uby
    dlx, dly = lbx - lox, lby - loy
    over_hx = _max_c(dhx, 0.0)
    over_hy = _max_c(dhy, 0.0)
    over_lx = _max_c(dlx, 0.0)
    over_ly = _max_c(dly, 0.0)
    pen_x = -over_hx + over_lx
    pen_y = -over_hy + over_ly
    depth = torch.maximum(torch.maximum(over_hx, over_hy), torch.maximum(over_lx, over_ly))
    active = depth > 0
    best = torch.maximum(torch.maximum(dhx, dhy), torch.maximum(dlx, dly))
    is_hx = best == dhx
    is_hy = ~is_hx & (best == dhy)
    is_lx = ~is_hx & ~is_hy & (best == dlx)

    def at(idx):
        return (torch.gather(vxa, 1, idx[:, None, :])[:, 0, :],
                torch.gather(vya, 1, idx[:, None, :])[:, 0, :])

    x_hx, y_hx = at(vxa.argmax(1))
    x_hy, y_hy = at(vya.argmax(1))
    x_lx, y_lx = at(vxa.argmin(1))
    x_ly, y_ly = at(vya.argmin(1))
    ptx = torch.where(is_hx, x_hx, torch.where(is_hy, x_hy, torch.where(is_lx, x_lx, x_ly)))
    pty = torch.where(is_hx, y_hx, torch.where(is_hy, y_hy, torch.where(is_lx, y_lx, y_ly)))
    return pen_x * active, pen_y * active, ptx, pty, active


def _poly_inward_normals_bm(avx, avy, em):
    """Unit inward edge normals of convex area polygons: ``[G, Ve, B]``
    planes and the ``[G, Ve, B]`` mask of real edges of nonzero length."""
    ex = torch.roll(avx, -1, dims=1) - avx
    ey = torch.roll(avy, -1, dims=1) - avy
    el2 = ex * ex + ey * ey
    inv = _rsqrt_safe(el2)
    return -ey * inv, ex * inv, em[:, :, None] & (el2 > 0)


def _area_cp_bm(cx, cy, r, avx, avy, em):
    """Circle held inside an area polygon: the push in along the edge the
    circle pokes furthest past (first largest wins).  Unlike the other
    lanes, the push is not masked by ``active``."""
    ninx, niny, valid = _poly_inward_normals_bm(avx, avy, em)
    d_in = (cx[:, None, :] - avx) * ninx + (cy[:, None, :] - avy) * niny
    viol = torch.where(valid, r[:, :, None] - d_in, -INF)  # [G, Ve, B]
    G, Ve, B = viol.shape
    best = avx.new_full((G, B), -INF)
    bnx = bny = avx.new_zeros((G, B))
    for e in range(Ve):
        take = viol[:, e, :] > best
        best = torch.where(take, viol[:, e, :], best)
        bnx = torch.where(take, ninx[:, e, :], bnx)
        bny = torch.where(take, niny[:, e, :], bny)
    depth = _max_c(best, 0.0)
    return bnx * depth, bny * depth, cx - bnx * r, cy - bny * r, best > 0


def _area_vp_bm(vxa, vya, avx, avy, em):
    """Vertices ``[G, Va, B]`` held inside an area polygon: the vertex that
    pokes furthest past any edge, pushed in along that edge (first largest
    wins, over edges and then over vertices); the push is not masked."""
    ninx, niny, valid = _poly_inward_normals_bm(avx, avy, em)
    G, Ve, B = ninx.shape
    depth = avx.new_full((G, B), -INF)
    bnx = bny = ptx = pty = avx.new_zeros((G, B))
    for v in range(vxa.shape[1]):
        vx_v = vxa[:, v : v + 1, :]
        vy_v = vya[:, v : v + 1, :]
        viol = torch.where(valid, -((vx_v - avx) * ninx + (vy_v - avy) * niny), -INF)
        pv = avx.new_full((G, B), -INF)
        enx = eny = avx.new_zeros((G, B))
        for e in range(Ve):
            take = viol[:, e, :] > pv
            pv = torch.where(take, viol[:, e, :], pv)
            enx = torch.where(take, ninx[:, e, :], enx)
            eny = torch.where(take, niny[:, e, :], eny)
        take = pv > depth
        depth = torch.where(take, pv, depth)
        bnx = torch.where(take, enx, bnx)
        bny = torch.where(take, eny, bny)
        ptx = torch.where(take, vxa[:, v, :], ptx)
        pty = torch.where(take, vya[:, v, :], pty)
    d = _max_c(depth, 0.0)
    return bnx * d, bny * d, ptx, pty, depth > 0


def _box_corners(xv, yv):
    """A box's ``[G, 2, B]`` (lb, ub) rows as the 4-corner ``[G, 4, B]``
    planes of ``box_corners``' order: upper, (ux, ly), lower, (lx, uy)."""
    lx, ux, ly, uy = xv[:, 0], xv[:, 1], yv[:, 0], yv[:, 1]
    return torch.stack([ux, ux, lx, lx], dim=1), torch.stack([uy, ly, ly, uy], dim=1)


# the analytic one-lane kernels on circles' centre rows and boxes' (lb, ub)
_ANALYTIC = ("cc", "cb", "bb", "area_cb")


def _overlap_bm(alx, ahx, aly, ahy, blx, bhx, bly, bhy):
    """Batch-minor AABB overlap ``[G, B]`` (see collider.BROADPHASE_MARGIN)."""
    m = BROADPHASE_MARGIN
    return (alx <= bhx + m) & (blx <= ahx + m) & (aly <= bhy + m) & (bly <= ahy + m)


# ---------------------------------------------------------------------------
# batched collide over the pair table
# ---------------------------------------------------------------------------


def check_batched_support(config, what: str = "the batch-minor path") -> None:
    """Refuse WorldConfigs the batched path does not implement, as the JAX
    package's does: its collide emits 2-lane SAT manifolds where a
    ``narrowphase="gjk_epa"`` pair table sizes one lane a pair, and its
    solve is the block solve.  The reference modes run on the per-world
    step, ``World.step``, on states with leading batch axes."""
    if config.narrowphase != "sat":
        raise ValueError(
            f"{what} supports narrowphase='sat' only, got "
            f"{config.narrowphase!r}: its collide emits 2-lane SAT "
            "manifolds while this pair table sizes one lane per pair. Use "
            "World.step on states with leading batch axes (the port of "
            "jax.vmap(world.step)) for reference-mode narrowphase, or build "
            "the world with narrowphase='sat'."
        )
    if config.solver_mode != "block":
        raise ValueError(
            f"{what} supports solver_mode='block' only, got "
            f"{config.solver_mode!r}; jacobi/gauss_seidel/"
            "random_one_per_body solvers run on the per-world path: "
            "World.step on states with leading batch axes (the port of "
            "jax.vmap(world.step))."
        )


def collide_batched(
    world, s: _SoA, terrain_override=None, inactive_without_axis=False
) -> ContactsBM:
    """All pair-group kernels in batch-minor layout -> flat ``[C, B]`` lanes.

    ``terrain_override``: optional dict ``{part_index: ([V, B] x, [V, B] y)}``
    of world-frame vertex planes for per-world geometry (the lander's
    terrain), spliced in place of those parts' transformed vertices.
    ``inactive_without_axis``: the fused step's rule for a pair with no
    valid axis (see :func:`_pp_manifold_bm`).
    """
    check_batched_support(world.config, "collide_batched")
    B = s.px.shape[-1]
    pieces = []

    def side(idx, vn):
        if terrain_override and any(i in terrain_override for i in idx):
            # override planes are world-frame already (static bodies); the
            # side's other parts get their full world-frame transform
            non_idx = tuple(i for i in idx if i not in terrain_override)
            if non_idx:
                wxn, wyn = _side_verts(world, s, non_idx, vn)
            lx, ly = [], []
            j = 0
            for i in idx:
                if i in terrain_override:
                    ox, oy = terrain_override[i]
                    lx.append(ox[:vn])
                    ly.append(oy[:vn])
                else:
                    lx.append(wxn[j])
                    ly.append(wyn[j])
                    j += 1
            return torch.stack(lx), torch.stack(ly)
        return _side_verts(world, s, tuple(idx), vn)

    broadphase = world.config.broadphase
    for g in world.table.groups:
        k = g.kernel
        Va, Vb, ema, emb = _group_rows(world, g)
        axv, ayv = side(g.part_a, Va)
        bxv, byv = side(g.part_b, Vb)
        ra, rb = _radii(world, g)
        if k in ("pp", "bp"):
            if k == "bp":  # the box as a 4-corner CCW polygon
                lbx, lby, ubx, uby = axv[:, 0], ayv[:, 0], axv[:, 1], ayv[:, 1]
                axv = torch.stack([lbx, ubx, ubx, lbx], dim=1)
                ayv = torch.stack([lby, lby, uby, uby], dim=1)
            px, py, qx, qy, act, wgt = _pp_manifold_bm(
                axv, ayv, ema, bxv, byv, emb, inactive_without_axis
            )
            if broadphase:
                ov = _overlap_bm(
                    axv.amin(1), axv.amax(1), ayv.amin(1), ayv.amax(1),
                    bxv.amin(1), bxv.amax(1), byv.amin(1), byv.amax(1),
                )[:, None, :]
                act = act & ov
                px, py = px * ov, py * ov
            pieces.append(tuple(x.reshape(2 * g.size, B) for x in (px, py, qx, qy, act, wgt)))
            continue
        # one lane a pair, weight 1, no partner.  Side A is a circle's centre
        # row or a box's (lb, ub) rows, or the contained body of an area
        # pair (side B the area); of these kernels only cp takes the
        # broadphase, the others mask themselves
        if k == "cc":
            lane = _cc_bm(axv[:, 0], ayv[:, 0], ra, bxv[:, 0], byv[:, 0], rb)
        elif k in ("cb", "area_cb"):
            box_lane = _cb_bm if k == "cb" else _area_cb_bm
            lane = box_lane(axv[:, 0], ayv[:, 0], ra,
                            bxv[:, 0], byv[:, 0], bxv[:, 1], byv[:, 1])
        elif k == "bb":
            lane = _bb_bm(axv[:, 0], ayv[:, 0], axv[:, 1], ayv[:, 1],
                          bxv[:, 0], byv[:, 0], bxv[:, 1], byv[:, 1])
        elif k == "cp":
            lane = _cp_bm(axv[:, 0], ayv[:, 0], ra, bxv, byv, emb)
            if broadphase:
                cx, cy = axv[:, 0], ayv[:, 0]
                ov = _overlap_bm(
                    cx - ra, cx + ra, cy - ra, cy + ra,
                    bxv.amin(1), bxv.amax(1), byv.amin(1), byv.amax(1),
                )
                px, py, qx, qy, act = lane
                lane = (px * ov, py * ov, qx, qy, act & ov)
        elif k in ("area_pb", "area_bb"):
            vx, vy = (axv, ayv) if k == "area_pb" else _box_corners(axv, ayv)
            lane = _area_vb_bm(vx, vy, bxv[:, 0], byv[:, 0], bxv[:, 1], byv[:, 1])
        elif k == "area_cp":
            lane = _area_cp_bm(axv[:, 0], ayv[:, 0], ra, bxv, byv, emb)
        elif k in ("area_pp", "area_bp"):
            vx, vy = (axv, ayv) if k == "area_pp" else _box_corners(axv, ayv)
            lane = _area_vp_bm(vx, vy, bxv, byv, emb)
        else:  # pragma: no cover: the pair table names no other kind
            raise ValueError(f"pair-group kernel {k!r}")
        pieces.append((*lane, torch.ones_like(lane[0])))

    if len(pieces) == 1:
        return ContactsBM(*pieces[0])
    return ContactsBM(*(torch.cat([p[k] for p in pieces], dim=0) for k in range(6)))


# ---------------------------------------------------------------------------
# batch-minor block solver: the plain torch version of the CUDA kernel
# ---------------------------------------------------------------------------


def solve_contacts_bm(
    world,
    s: _SoA,
    con: ContactsBM,
    iterations: int,
    position_iterations: int,
    dt: float,
    config: ContactSolverConfig,
) -> _SoA:
    """Jacobi sequential-impulse contact solve over ``[C, B]`` lanes.

    Each pass computes every lane's new impulse from one velocity snapshot
    and then adds the summed deltas to the bodies.  Manifold lane pairs
    solve a 2x2 block LCP for the normal impulses and a coupled 2x2 system
    for friction; ``position_iterations`` split-impulse passes correct the
    positions.
    """
    C = world.table.n_contacts
    if C == 0:
        return s
    t = _solver_index(world)
    ia, ib = t.ia, t.ib

    def pswap(x):
        return x[t.ip]

    params = world.params
    inv_mass = params.inv_mass
    inv_inertia = params.inv_inertia
    im_a = inv_mass[ia][:, None]
    im_b = inv_mass[ib][:, None]
    ii_a = inv_inertia[ia][:, None]
    ii_b = inv_inertia[ib][:, None]
    el = params.elasticity
    if config.restitution_mode == "min":
        e = torch.minimum(el[ia], el[ib])[:, None]
    else:
        e = ((el[ia] + el[ib]) / 2)[:, None]
    mu = ((params.friction[ia] + params.friction[ib]) / 2)[:, None]

    d2 = con.pen_x**2 + con.pen_y**2
    inv_d = _rsqrt_safe(d2)
    depth = d2 * inv_d
    nx = torch.where(d2 == 0, 0.0, con.pen_x * inv_d)
    ny = torch.where(d2 == 0, 0.0, con.pen_y * inv_d)
    tx, ty = -ny, nx  # tangent

    rax = con.pt_x - s.px[ia]
    ray = con.pt_y - s.py[ia]
    rbx = con.pt_x - s.px[ib]
    rby = con.pt_y - s.py[ib]
    ran = rax * ny - ray * nx
    rbn = rbx * ny - rby * nx
    rat = rax * ty - ray * tx
    rbt = rbx * ty - rby * tx
    k_n = im_a + im_b + ii_a * ran * ran + ii_b * rbn * rbn
    k_t = im_a + im_b + ii_a * rat * rat + ii_b * rbt * rbt
    k_np = im_a + im_b + ii_a * ran * pswap(ran) + ii_b * rbn * pswap(rbn)
    k_tp = im_a + im_b + ii_a * rat * pswap(rat) + ii_b * rbt * pswap(rbt)
    inv_kn = 1.0 / torch.where(k_n == 0, 1.0, k_n)
    inv_kt = 1.0 / torch.where(k_t == 0, 1.0, k_t)

    active = con.active

    def rel_vel(vx, vy, om):
        vax = vx[ia] - ray * om[ia]
        vay = vy[ia] + rax * om[ia]
        vbx = vx[ib] - rby * om[ib]
        vby = vy[ib] + rbx * om[ib]
        rx = vbx - vax
        ry = vby - vay
        return rx * nx + ry * ny, rx * tx + ry * ty

    v_n0, _ = rel_vel(s.vx, s.vy, s.omega)
    bias = (
        config.baumgarte
        * _max_c(depth - config.baumgarte_slop, 0.0)
        / config.baumgarte_dt
    )
    if config.baumgarte_max_bias is not None:
        bias = _min_c(bias, config.baumgarte_max_bias)
    rest = torch.where(v_n0 > 0, e * _max_c(v_n0, 0.0), 0.0)
    split = position_iterations > 0
    target = torch.where(active, rest if split else rest + bias, 0.0)
    bias = torch.where(active, bias, 0.0)

    n = world.n_bodies
    B = s.px.shape[-1]

    def scatter(dj_n, dj_t, vx, vy, om):
        """Add the lanes' impulse deltas to their movable bodies."""
        jx = dj_n * nx + dj_t * tx
        jy = dj_n * ny + dj_t * ty
        da = torch.stack([jx * im_a, jy * im_a, (rax * jy - ray * jx) * ii_a])
        db = torch.stack([-jx * im_b, -jy * im_b, -(rbx * jy - rby * jx) * ii_b])
        acc = s.px.new_zeros((3, n, B)).index_add_(1, t.iab, torch.cat([da, db], 1))
        # static bodies never move: skip their rows (0 * inf would be NaN)
        acc = torch.where(t.movable, acc, 0.0)
        return vx + acc[0], vy + acc[1], om + acc[2]

    k_p = pswap(k_n)
    inv_kp = 1.0 / torch.where(k_p == 0, 1.0, k_p)
    det = k_n * k_p - k_np * k_np
    ok_det = torch.abs(det) >= 1e-12
    safe_det = torch.where(ok_det, det, 1.0)
    k_tpd = pswap(k_t)
    det_t = k_t * k_tpd - k_tp * k_tp
    # relative threshold: face contacts have identical tangential Jacobians
    # on both manifold points (det_t == 0 up to noise); treat near-singular
    # as redundant and split the correction between the lanes
    ok_det_t = torch.abs(det_t) >= 1e-5 * k_t * k_tpd
    safe_det_t = torch.where(ok_det_t, det_t, 1.0)
    inv_kt_coupled = 1.0 / torch.where(k_t + k_tp == 0, 1.0, k_t + k_tp)

    # a manifold block is solved jointly only when both its lanes are active
    blockable = t.has_p & active & pswap(active)

    def normal_pass(vx, vy, om, jn):
        v_n, _ = rel_vel(vx, vy, om)
        rhs = v_n + target
        jn_single = _max_c(jn + rhs * inv_kn, 0.0)

        rhs_p = pswap(rhs)
        jn_p = pswap(jn)
        b0 = k_n * jn + k_np * jn_p + rhs
        b1 = k_np * jn + k_p * jn_p + rhs_p
        x0_full = (k_p * b0 - k_np * b1) / safe_det
        x1_full = (k_n * b1 - k_np * b0) / safe_det
        ok_full = (x0_full >= 0) & (x1_full >= 0) & ok_det
        x0_c2 = _max_c(b0 * inv_kn, 0.0)
        ok_c2 = k_np * x0_c2 - b1 >= -1e-9
        x1_c3 = _max_c(b1 * inv_kp, 0.0)
        ok_c3 = k_np * x1_c3 - b0 >= -1e-9
        x0 = torch.where(ok_full, x0_full, torch.where(ok_c2, x0_c2, 0.0))
        x1 = torch.where(
            ok_full, x1_full,
            torch.where(ok_c2, 0.0, torch.where(ok_c3, x1_c3, 0.0)),
        )
        jn_block = torch.where(t.is_lead, x0, pswap(x1))
        jn_new = torch.where(blockable, jn_block, jn_single)
        jn_new = torch.where(active, jn_new, 0.0)
        vx, vy, om = scatter(jn_new - jn, torch.zeros_like(jn), vx, vy, om)
        return vx, vy, om, jn_new

    def friction_pass(vx, vy, om, jn, jt):
        _, v_t = rel_vel(vx, vy, om)
        jt_single = jt + v_t * inv_kt
        # redundant (singular) case: applying x at both coupled points
        # changes v_t by x*(k_t + k_tp) -> least-norm split
        jt_split = jt + v_t * inv_kt_coupled
        v_t_p = pswap(v_t)
        jt_p = pswap(jt)
        bt0 = k_t * jt + k_tp * jt_p + v_t
        bt1 = k_tp * jt + k_tpd * jt_p + v_t_p
        xt0 = (k_tpd * bt0 - k_tp * bt1) / safe_det_t
        xt1 = (k_t * bt1 - k_tp * bt0) / safe_det_t
        jt_block = torch.where(t.is_lead, xt0, pswap(xt1))
        jt_block = torch.where(ok_det_t, jt_block, jt_split)
        jt_new = torch.where(blockable, jt_block, jt_single)
        lim = mu * jn
        jt_new = torch.minimum(torch.maximum(jt_new, -lim), lim)
        jt_new = torch.where(active, jt_new, 0.0)
        vx, vy, om = scatter(torch.zeros_like(jt), jt_new - jt, vx, vy, om)
        return vx, vy, om, jt_new

    vx, vy, om = s.vx, s.vy, s.omega
    jn = torch.zeros_like(con.pen_x)
    jt = torch.zeros_like(jn)
    for _ in range(iterations):
        vx, vy, om, jn = normal_pass(vx, vy, om, jn)
        vx, vy, om, jt = friction_pass(vx, vy, om, jn, jt)
    s = s._replace(vx=vx, vy=vy, omega=om)

    if split:
        pvx = torch.zeros_like(vx)
        pvy = torch.zeros_like(vy)
        pom = torch.zeros_like(om)
        pj = torch.zeros_like(jn)
        for _ in range(position_iterations):
            v_n, _ = rel_vel(pvx, pvy, pom)
            rhs = v_n + bias
            pj_new = torch.where(active, _max_c(pj + rhs * inv_kn, 0.0), 0.0)
            pvx, pvy, pom = scatter(pj_new - pj, torch.zeros_like(pj), pvx, pvy, pom)
            pj = pj_new
        s = s._replace(
            px=s.px + pvx * dt, py=s.py + pvy * dt, angle=s.angle + pom * dt
        )
    return s


# ---------------------------------------------------------------------------
# batch-minor joints (Gauss-Seidel in joint order)
# ---------------------------------------------------------------------------


def apply_joints_bm(world, s: _SoA) -> _SoA:
    """Gauss-Seidel spring-damper joints, batch-minor (plain torch)."""
    if world.joints.n_joints == 0:
        return s
    from parallax_tpu_torch.ops.contact_solver import apply_joint_rows, joint_rows

    rows, im, ii = joint_rows(world)
    vx, vy, om = apply_joint_rows(
        rows, im, ii, s.px, s.py, s.vx, s.vy, s.angle, s.omega
    )
    return s._replace(vx=vx, vy=vy, omega=om)


# ---------------------------------------------------------------------------
# the batched step
# ---------------------------------------------------------------------------


def integrate_bm(world, s: _SoA, dt: Optional[float] = None, accel=None):
    """The step's first phase, integration and gravity (movable bodies
    only), in the order ``WorldConfig.integrator`` names.  Returns ``(s,
    dt)`` with ``dt`` resolved from the config when None."""
    cfg = world.config
    dt = cfg.dt if dt is None else dt
    gx, gy = cfg.gravity
    if accel is not None:
        gx = gx + accel[0]
        gy = gy + accel[1]

    mov = world.static(
        ("gravity_mask",),
        lambda: torch.isfinite(world.params.mass).to(torch.float32)[:, None],
    )

    def integrate(s):
        return s._replace(
            px=s.px + s.vx * dt,
            py=s.py + s.vy * dt,
            angle=s.angle + s.omega * dt,
        )

    def grav(s):
        return s._replace(vx=s.vx + gx * dt * mov, vy=s.vy + gy * dt * mov)

    if cfg.integrator == "symplectic":
        return integrate(grav(s)), dt
    return grav(integrate(s)), dt


def step_batched(
    world,
    state: BodyState,
    dt: Optional[float] = None,
    accel=None,
    terrain_override=None,
    pre=None,
    post=None,
) -> tuple[BodyState, ContactsBM]:
    """Batched world step, batch axis leading in ``state`` (``[B, n, ...]``).

    The JAX package's batched equivalent of ``jax.vmap(world.step)`` for
    ``solver_mode="block"`` and ``narrowphase="sat"``: it runs
    :func:`physics_core` in the batch-minor frame, so ``use_cuda_solver`` and
    ``use_cuda_fused`` choose the kernels as they do for the envs.  Returns
    ``(state, ContactsBM [C, B])`` (the fused step exports only ``active``).

    ``pre``/``post``: optional ``(_SoA) -> _SoA`` hooks run in the
    batch-minor frame, before the integration and after the joints.
    """
    s = _to_soa(state)
    if pre is not None:
        s = pre(s)
    s, con = physics_core(world, s, dt=dt, accel=accel, terrain_override=terrain_override)
    if post is not None:
        s = post(s)
    return _from_soa(s), con


def _collide_span(world, s: _SoA, terrain_override=None) -> ContactsBM:
    """``collide_batched`` inside the ``px.collide`` span (inside the
    checkpoint on the remat path, so its recompute shows the span too)."""
    with named("px.collide"):
        return collide_batched(world, s, terrain_override)


def physics_core(
    world, s: _SoA, dt: Optional[float] = None, accel=None, terrain_override=None
) -> tuple[_SoA, ContactsBM]:
    """The full physics step in the batch-minor frame (integrate + gravity +
    collide + solve + joints).  Plane-space rollouts loop over this."""
    check_batched_support(world.config)
    cfg = world.config
    if cfg.use_cuda_fused:
        from parallax_tpu_torch.ops.fused_step import physics_core_fused

        return physics_core_fused(
            world, s, terrain_override=terrain_override, dt=dt, accel=accel
        )

    s, dt = integrate_bm(world, s, dt, accel)
    if _REMAT_COLLIDE:
        con = torch.utils.checkpoint.checkpoint(
            _collide_span, world, s, terrain_override, use_reentrant=False
        )
    else:
        con = _collide_span(world, s, terrain_override)
    if cfg.use_cuda_solver and world.table.n_contacts > 0:
        from parallax_tpu_torch.ops.contact_solver import solve_contacts

        # the joints ride inside the kernel
        s = solve_contacts(
            world, s, con,
            iterations=cfg.solver_iterations,
            position_iterations=cfg.position_iterations,
            dt=dt, config=cfg.contact,
        )
    else:
        s = solve_contacts_bm(
            world, s, con,
            iterations=cfg.solver_iterations,
            position_iterations=cfg.position_iterations,
            dt=dt, config=cfg.contact,
        )
        s = apply_joints_bm(world, s)
    return s, con
