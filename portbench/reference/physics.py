"""The physics step of a batch of 2D rigid-body worlds, in plain torch.

Written from the published semantics of parallax's batched step (the JAX
package's ``engine/batched.py``: ``physics_core`` with the "block" solver):

1. integrate: ``reference`` order moves positions by the velocities, then
   kicks the movable bodies' velocities by gravity; ``symplectic`` the
   other way round;
2. collide every pair of the world's pair table into contact lanes:
   polygon pairs by SAT with a two-point clipped manifold (two lanes,
   partners of each other), circle-circle and circle-box analytically
   (one lane);
3. solve the lanes: ``iterations`` Jacobi passes of normal impulses
   (partner lanes that are both active solved as a 2x2 block LCP) and of
   friction (partners as a coupled 2x2 system, clamped to the Coulomb
   cone), then ``position_iterations`` split-impulse passes of the
   Baumgarte bias whose velocities move the positions by ``dt``;
4. the joints' spring-dampers, one after the other.

Everything is batch-major: body planes ``[B, n]``, lanes ``[B, C]``.  The
per-body sums of lane impulses are gathers over each body's own list of
lanes, so they are deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

INF = float("inf")


class Bodies(NamedTuple):
    """Body planes, each ``[B, n]``."""

    px: torch.Tensor
    py: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    ang: torch.Tensor
    om: torch.Tensor


class Lanes(NamedTuple):
    """Contact lanes, each ``[B, C]``."""

    pen_x: torch.Tensor
    pen_y: torch.Tensor
    pt_x: torch.Tensor
    pt_y: torch.Tensor
    active: torch.Tensor


@dataclass
class Solver:
    iterations: int
    position_iterations: int
    baumgarte: float = 0.3
    baumgarte_dt: float = 0.01
    slop: float = 0.005
    max_bias: float = 0.5


@dataclass
class Joint:
    a: int
    b: int
    anchor_a: tuple
    anchor_b: tuple
    kp: float = 1.0
    kd: float = 0.05
    v0: float = 0.1


@dataclass
class World:
    """One world's static description; every world of a batch shares it.

    ``lanes_a``/``lanes_b``/``partner`` are the contact lanes' bodies and
    partner lanes (-1 without one), in the order the collide emits them."""

    mass: list
    inertia: list
    elasticity: list
    friction: list
    dt: float
    gravity: tuple
    integrator: str
    solver: Solver
    lanes_a: list
    lanes_b: list
    partner: list
    joints: list = field(default_factory=list)

    def tables(self, device):
        """Device tensors the step reads, made once."""
        if getattr(self, "_tables", None) and self._tables["device"] == device:
            return self._tables
        f32 = dict(dtype=torch.float32, device=device)
        mass = np.asarray(self.mass, np.float32)
        inertia = np.asarray(self.inertia, np.float32)
        im = (np.float32(1.0) / mass).astype(np.float32)  # infinite mass -> 0
        ii = (np.float32(1.0) / inertia).astype(np.float32)
        e = np.asarray(self.elasticity, np.float32)
        mu = np.asarray(self.friction, np.float32)
        ia = np.asarray(self.lanes_a, np.int64)
        ib = np.asarray(self.lanes_b, np.int64)
        partner = np.asarray(self.partner, np.int64)
        C, n = len(ia), len(mass)
        has_p = partner >= 0
        # each movable body's lanes: index c into [da | db] for side a,
        # C + c for side b; padded with 2C, a column of zeros
        movable = np.isfinite(mass)
        per_body = [([c for c in range(C) if ia[c] == b] + [C + c for c in range(C) if ib[c] == b])
                    if movable[b] else [] for b in range(n)]
        width = max(1, max(len(x) for x in per_body))
        gather = np.full((n, width), 2 * C, np.int64)
        for b, idx in enumerate(per_body):
            gather[b, : len(idx)] = idx
        self._tables = dict(
            device=device,
            im=torch.tensor(im, **f32), ii=torch.tensor(ii, **f32),
            ia=torch.tensor(ia, device=device), ib=torch.tensor(ib, device=device),
            ip=torch.tensor(np.where(has_p, partner, np.arange(C)), device=device),
            has_p=torch.tensor(has_p, device=device),
            lead=torch.tensor(has_p & (partner > np.arange(C)), device=device),
            e=torch.tensor(np.minimum(e[ia], e[ib]), **f32),  # restitution: the smaller
            mu=torch.tensor((mu[ia] + mu[ib]) / np.float32(2), **f32),
            movable=torch.tensor(movable.astype(np.float32), **f32),
            gather=torch.tensor(gather, device=device),
        )
        return self._tables


def rsqrt_safe(x):
    return torch.rsqrt(torch.where(x <= 0, torch.ones_like(x), x))


def safe_div(a, b):
    return a / torch.where(b == 0, torch.ones_like(b), b)


def clip(x, lo, hi):
    """``min(max(x, lo), hi)``: at a tie each side takes half the gradient."""
    x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype, device=x.device))
    return torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype, device=x.device))


def abs_(x):
    """``|x|`` whose gradient at 0 is +1."""
    return torch.where(x >= 0, x, -x)


# ---------------------------------------------------------------------------
# 1. integration
# ---------------------------------------------------------------------------


def integrate(world: World, s: Bodies) -> Bodies:
    t = world.tables(s.px.device)
    dt = world.dt
    gx, gy = world.gravity

    def move(s):
        return s._replace(px=s.px + s.vx * dt, py=s.py + s.vy * dt, ang=s.ang + s.om * dt)

    def kick(s):
        return s._replace(vx=s.vx + (gx * dt) * t["movable"], vy=s.vy + (gy * dt) * t["movable"])

    if world.integrator == "symplectic":
        return move(kick(s))
    return kick(move(s))


# ---------------------------------------------------------------------------
# 2. contacts
# ---------------------------------------------------------------------------


def world_vertices(lx, ly, px, py, ang):
    """Local polygon vertices ``[V]`` (or ``[B, V]``) of one body placed at
    its pose ``[B]``: ``[B, V]`` x and y."""
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    return c * lx - s * ly + px[:, None], s * lx + c * ly + py[:, None]


def _edge_normals(x, y, mask):
    """Unit outward normals of the edges ``v -> v+1`` (last to first) of
    ``[..., V]`` polygons and whether each is a real, nonzero edge."""
    ex = torch.roll(x, -1, -1) - x
    ey = torch.roll(y, -1, -1) - y
    nx, ny = ey, -ex
    ln2 = nx * nx + ny * ny
    inv = rsqrt_safe(ln2)
    return nx * inv, ny * inv, mask & (ln2 > 0)


def _take(x, idx):
    return torch.gather(x, -1, idx[..., None])[..., 0]


def polygon_manifold(ax, ay, amask, bx, by, bmask):
    """Polygon pairs ``[B, G, Va]`` / ``[B, G, Vb]`` (repeat-padded vertex
    lists; the masks ``[G, V]`` mark the real edges) -> two lanes a pair,
    each ``[B, G, 2]``: penetration (pushing A out of B), point, active.

    The separating axis is the first of A's then B's edge normals with the
    least overlap; a pair with no real edge at all is inactive.  The
    reference face is the better aligned of the two polygons' faces along
    that axis (A's on a tie); the other polygon's best aligned face is
    clipped to the reference face's side planes, and the clipped points
    within the depth (at least 1e-4) of the face are the contacts, weighted
    evenly; when none is, the first point takes the whole depth.
    """
    nax, nay, aok = _edge_normals(ax, ay, amask)
    nbx, nby, bok = _edge_normals(bx, by, bmask)
    NX = torch.cat([nax, nbx], -1)  # [B, G, A]
    NY = torch.cat([nay, nby], -1)
    OK = torch.cat([aok.expand_as(nax), bok.expand_as(nbx)], -1)

    def extent(x, y):
        p = NX[..., :, None] * x[..., None, :] + NY[..., :, None] * y[..., None, :]
        return p.amin(-1), p.amax(-1)

    mna, mxa = extent(ax, ay)
    mnb, mxb = extent(bx, by)
    o_pos = mxb - mna
    o_neg = mxa - mnb
    ovl = torch.where(OK, torch.minimum(o_pos, o_neg), torch.full_like(o_pos, INF))
    k = torch.argmin(ovl, -1)  # the first least overlap
    best = _take(ovl, k)
    sign = torch.where(_take(o_pos, k) <= _take(o_neg, k), 1.0, -1.0)
    any_axis = OK.any(-1)
    active = (best >= 0) & any_axis
    depth = torch.where(any_axis, torch.clamp(best, min=0.0), torch.zeros_like(best))
    nx = torch.where(any_axis, _take(NX, k), torch.zeros_like(best)) * sign
    ny = torch.where(any_axis, _take(NY, k), torch.zeros_like(best)) * sign

    def face(fx, fy, ok, x, y, dx, dy):
        al = fx * dx[..., None] + fy * dy[..., None]
        al = torch.where(ok, al, torch.full_like(al, -INF))
        j = torch.argmax(al, -1)  # the first best aligned
        x1, y1 = torch.roll(x, -1, -1), torch.roll(y, -1, -1)
        return _take(al, j), _take(x, j), _take(y, j), _take(x1, j), _take(y1, j)

    al_a, a0x, a0y, a1x, a1y = face(nax, nay, aok.expand_as(nax), ax, ay, -nx, -ny)
    al_b, b0x, b0y, b1x, b1y = face(nbx, nby, bok.expand_as(nbx), bx, by, nx, ny)
    ref_a = al_a >= al_b
    r0x, r0y = torch.where(ref_a, a0x, b0x), torch.where(ref_a, a0y, b0y)
    r1x, r1y = torch.where(ref_a, a1x, b1x), torch.where(ref_a, a1y, b1y)
    nrx, nry = torch.where(ref_a, -nx, nx), torch.where(ref_a, -ny, ny)
    i0x, i0y = torch.where(ref_a, b0x, a0x), torch.where(ref_a, b0y, a0y)
    i1x, i1y = torch.where(ref_a, b1x, a1x), torch.where(ref_a, b1y, a1y)

    tx, ty = r1x - r0x, r1y - r0y
    tl = rsqrt_safe(tx * tx + ty * ty)
    tx, ty = tx * tl, ty * tl

    def clip_side(p0x, p0y, p1x, p1y, ox, oy, dx, dy):
        d0 = (p0x - ox) * dx + (p0y - oy) * dy
        d1 = (p1x - ox) * dx + (p1y - oy) * dy
        frac = safe_div(d0, d0 - d1)
        cx, cy = p0x + frac * (p1x - p0x), p0y + frac * (p1y - p0y)
        in0 = (d0 < 0) & (d1 >= 0)
        in1 = (d1 < 0) & (d0 >= 0)
        return (torch.where(in0, cx, p0x), torch.where(in0, cy, p0y),
                torch.where(in1, cx, p1x), torch.where(in1, cy, p1y))

    c0x, c0y, c1x, c1y = clip_side(i0x, i0y, i1x, i1y, r0x, r0y, tx, ty)
    c0x, c0y, c1x, c1y = clip_side(c0x, c0y, c1x, c1y, r1x, r1y, -tx, -ty)
    d0 = -((c0x - r0x) * nrx + (c0y - r0y) * nry)
    d1 = -((c1x - r0x) * nrx + (c1y - r0y) * nry)
    tol = torch.clamp(depth, min=1e-4)
    k0, k1 = d0 >= -tol, d1 >= -tol
    none = ~(k0 | k1)
    a0 = active & (none | k0)
    a1 = active & ~none & k1
    l0 = torch.where(none, depth, torch.clamp(d0, min=1e-6))
    l1 = torch.where(none, depth, torch.clamp(d1, min=1e-6))
    pen_x = torch.stack([nx * l0 * a0, nx * l1 * a1], -1)
    pen_y = torch.stack([ny * l0 * a0, ny * l1 * a1], -1)
    return (pen_x, pen_y, torch.stack([c0x, c1x], -1), torch.stack([c0y, c1y], -1),
            torch.stack([a0, a1], -1))


def circle_circle(ax, ay, ra, bx, by, rb):
    """Circle pairs ``[B, G]`` -> one lane a pair: penetration pushing A out
    of B along the centres' line, the point midway between the two surfaces
    (or the centre of the circle inside the other where both surfaces lie
    on one side of it)."""
    dx, dy = ax - bx, ay - by
    d2 = dx * dx + dy * dy
    inv = rsqrt_safe(d2)
    dist = d2 * inv
    ux = torch.where(d2 == 0, torch.ones_like(dx), dx * inv)
    uy = torch.where(d2 == 0, torch.zeros_like(dy), dy * inv)
    depth = torch.clamp(ra + rb - dist, min=0.0)
    active = dist <= ra + rb
    ptx = (bx + ux * (rb - ra) + ax) / 2
    pty = (by + uy * (rb - ra) + ay) / 2
    same_side = (ax - ptx) * (bx - ptx) + (ay - pty) * (by - pty) > 0
    b_in_a = (bx - ax) * (bx - ax) + (by - ay) * (by - ay) <= (ra + 1e-6) * (ra + 1e-6)
    ptx = torch.where(same_side, torch.where(b_in_a, bx, ax), ptx)
    pty = torch.where(same_side, torch.where(b_in_a, by, ay), pty)
    return ux * depth * active, uy * depth * active, ptx, pty, active


def circle_box(cx, cy, r, lx, ly, ux, uy, eps=1e-6):
    """A circle ``[B, G]`` against an axis-aligned box: the box's closest
    point is the contact; at a corner the penetration runs from the centre
    through it, else it is the least of the four single-axis pushes (below,
    above, left, right; the first on a tie)."""
    qx, qy = clip(cx, lx, ux), clip(cy, ly, uy)
    at_x = (abs_(qx - lx) < eps) | (abs_(qx - ux) < eps)
    at_y = (abs_(qy - ly) < eps) | (abs_(qy - uy) < eps)
    corner = at_x & at_y
    vx, vy = qx - cx, qy - cy
    dd = vx * vx + vy * vy
    inv = rsqrt_safe(dd)
    nx = torch.where(dd == 0, torch.ones_like(vx), vx * inv)
    ny = torch.where(dd == 0, torch.zeros_like(vy), vy * inv)
    cpx, cpy = -(cx + r * nx - qx), -(cy + r * ny - qy)
    pushes = torch.stack([cy + r - ly, uy - (cy - r), cx + r - lx, ux - (cx - r)], -1)
    k = torch.argmin(pushes, -1)
    m = _take(pushes, k)
    zero = torch.zeros_like(m)
    fx = torch.where(k == 2, -m, torch.where(k == 3, m, zero))
    fy = torch.where(k == 0, -m, torch.where(k == 1, m, zero))
    active = (cx - qx) * (cx - qx) + (cy - qy) * (cy - qy) <= (r + eps) * (r + eps)
    pen_x = torch.where(corner, cpx, fx) * active
    pen_y = torch.where(corner, cpy, fy) * active
    return pen_x, pen_y, qx, qy, active


# ---------------------------------------------------------------------------
# 3. the contact solve
# ---------------------------------------------------------------------------


def solve(world: World, s: Bodies, con: Lanes) -> Bodies:
    t = world.tables(s.px.device)
    cfg = world.solver
    ia, ib, ip = t["ia"], t["ib"], t["ip"]
    im_a, im_b, ii_a, ii_b = t["im"][ia], t["im"][ib], t["ii"][ia], t["ii"][ib]
    active = con.active

    def p(x):
        return x[:, ip]

    def body_sum(da, db):
        both = torch.cat([da, db, torch.zeros_like(da[:, :1])], -1)
        return both[:, t["gather"]].sum(-1)

    d2 = con.pen_x * con.pen_x + con.pen_y * con.pen_y
    inv_d = rsqrt_safe(d2)
    depth = d2 * inv_d
    nx = torch.where(d2 == 0, torch.zeros_like(d2), con.pen_x * inv_d)
    ny = torch.where(d2 == 0, torch.zeros_like(d2), con.pen_y * inv_d)
    tx, ty = -ny, nx
    rax, ray = con.pt_x - s.px[:, ia], con.pt_y - s.py[:, ia]
    rbx, rby = con.pt_x - s.px[:, ib], con.pt_y - s.py[:, ib]
    ran, rbn = rax * ny - ray * nx, rbx * ny - rby * nx
    rat, rbt = rax * ty - ray * tx, rbx * ty - rby * tx
    k_n = im_a + im_b + ii_a * ran * ran + ii_b * rbn * rbn
    k_t = im_a + im_b + ii_a * rat * rat + ii_b * rbt * rbt
    k_np = im_a + im_b + ii_a * ran * p(ran) + ii_b * rbn * p(rbn)
    k_tp = im_a + im_b + ii_a * rat * p(rat) + ii_b * rbt * p(rbt)
    k_p, k_tpd = p(k_n), p(k_t)
    inv_kn, inv_kt, inv_kp = 1.0 / _nz(k_n), 1.0 / _nz(k_t), 1.0 / _nz(k_p)
    det = k_n * k_p - k_np * k_np
    ok_det = abs_(det) >= 1e-12
    det = torch.where(ok_det, det, torch.ones_like(det))
    det_t = k_t * k_tpd - k_tp * k_tp
    ok_det_t = abs_(det_t) >= 1e-5 * k_t * k_tpd  # a face's two points: split evenly
    det_t = torch.where(ok_det_t, det_t, torch.ones_like(det_t))
    inv_kt2 = 1.0 / _nz(k_t + k_tp)
    block = t["has_p"] & active & p(active)
    lead = t["lead"]

    def rel_vel(vx, vy, om):
        rx = (vx[:, ib] - rby * om[:, ib]) - (vx[:, ia] - ray * om[:, ia])
        ry = (vy[:, ib] + rbx * om[:, ib]) - (vy[:, ia] + rax * om[:, ia])
        return rx * nx + ry * ny, rx * tx + ry * ty

    def apply(dn, dt_, vx, vy, om):
        jx, jy = dn * nx + dt_ * tx, dn * ny + dt_ * ty
        vx = vx + body_sum(jx * im_a, -jx * im_b)
        vy = vy + body_sum(jy * im_a, -jy * im_b)
        om = om + body_sum((rax * jy - ray * jx) * ii_a, -(rbx * jy - rby * jx) * ii_b)
        return vx, vy, om

    v_n0, _ = rel_vel(s.vx, s.vy, s.om)
    bias = cfg.baumgarte * torch.clamp(depth - cfg.slop, min=0.0) / cfg.baumgarte_dt
    bias = torch.clamp(bias, max=cfg.max_bias)
    rest = torch.where(v_n0 > 0, t["e"] * torch.clamp(v_n0, min=0.0), torch.zeros_like(v_n0))
    split = cfg.position_iterations > 0
    zero = torch.zeros_like(depth)
    target = torch.where(active, rest if split else rest + bias, zero)
    bias = torch.where(active, bias, zero)

    vx, vy, om = s.vx, s.vy, s.om
    jn, jt = zero, zero
    for _ in range(cfg.iterations):
        v_n, _ = rel_vel(vx, vy, om)
        rhs = v_n + target
        single = torch.clamp(jn + rhs * inv_kn, min=0.0)
        b0 = k_n * jn + k_np * p(jn) + rhs
        b1 = k_np * jn + k_p * p(jn) + p(rhs)
        x0 = (k_p * b0 - k_np * b1) / det
        x1 = (k_n * b1 - k_np * b0) / det
        both = (x0 >= 0) & (x1 >= 0) & ok_det
        x0c = torch.clamp(b0 * inv_kn, min=0.0)
        only0 = k_np * x0c - b1 >= -1e-9
        x1c = torch.clamp(b1 * inv_kp, min=0.0)
        only1 = k_np * x1c - b0 >= -1e-9
        y0 = torch.where(both, x0, torch.where(only0, x0c, zero))
        y1 = torch.where(both, x1, torch.where(only0, zero, torch.where(only1, x1c, zero)))
        jn_new = torch.where(block, torch.where(lead, y0, p(y1)), single)
        jn_new = torch.where(active, jn_new, zero)
        vx, vy, om = apply(jn_new - jn, zero, vx, vy, om)
        jn = jn_new

        _, v_t = rel_vel(vx, vy, om)
        single = jt + v_t * inv_kt
        even = jt + v_t * inv_kt2
        bt0 = k_t * jt + k_tp * p(jt) + v_t
        bt1 = k_tp * jt + k_tpd * p(jt) + p(v_t)
        xt0 = (k_tpd * bt0 - k_tp * bt1) / det_t
        xt1 = (k_t * bt1 - k_tp * bt0) / det_t
        coupled = torch.where(ok_det_t, torch.where(lead, xt0, p(xt1)), even)
        jt_new = torch.where(block, coupled, single)
        lim = t["mu"] * jn
        jt_new = clip(jt_new, -lim, lim)
        jt_new = torch.where(active, jt_new, zero)
        vx, vy, om = apply(zero, jt_new - jt, vx, vy, om)
        jt = jt_new
    s = s._replace(vx=vx, vy=vy, om=om)

    if split:
        pvx, pvy, pom = torch.zeros_like(vx), torch.zeros_like(vy), torch.zeros_like(om)
        pj = zero
        for _ in range(cfg.position_iterations):
            v_n, _ = rel_vel(pvx, pvy, pom)
            pj_new = torch.where(active, torch.clamp(pj + (v_n + bias) * inv_kn, min=0.0), zero)
            pvx, pvy, pom = apply(pj_new - pj, zero, pvx, pvy, pom)
            pj = pj_new
        s = s._replace(px=s.px + pvx * world.dt, py=s.py + pvy * world.dt,
                       ang=s.ang + pom * world.dt)
    return s


def _nz(x):
    return torch.where(x == 0, torch.ones_like(x), x)


# ---------------------------------------------------------------------------
# 4. joints
# ---------------------------------------------------------------------------


def joints(world: World, s: Bodies) -> Bodies:
    """Each joint in turn pulls its two anchors together: an impulse
    ``kp * gap + kd * (|dv| + v0) * dv`` from A to B at the anchors."""
    if not world.joints:
        return s
    t = world.tables(s.px.device)
    im, ii = t["im"], t["ii"]
    vx = list(s.vx.unbind(1))
    vy = list(s.vy.unbind(1))
    om = list(s.om.unbind(1))
    for j in world.joints:
        a, b = j.a, j.b
        ca, sa = torch.cos(s.ang[:, a]), torch.sin(s.ang[:, a])
        cb, sb = torch.cos(s.ang[:, b]), torch.sin(s.ang[:, b])
        pax = s.px[:, a] + ca * j.anchor_a[0] - sa * j.anchor_a[1]
        pay = s.py[:, a] + sa * j.anchor_a[0] + ca * j.anchor_a[1]
        pbx = s.px[:, b] + cb * j.anchor_b[0] - sb * j.anchor_b[1]
        pby = s.py[:, b] + sb * j.anchor_b[0] + cb * j.anchor_b[1]
        rax, ray = pax - s.px[:, a], pay - s.py[:, a]
        rbx, rby = pbx - s.px[:, b], pby - s.py[:, b]
        dvx = (vx[a] - ray * om[a]) - (vx[b] - rby * om[b])
        dvy = (vy[a] + rax * om[a]) - (vy[b] + rbx * om[b])
        speed = torch.sqrt(torch.clamp(dvx * dvx + dvy * dvy, min=1e-30))
        jx = (pax - pbx) * j.kp + dvx * (speed + j.v0) * j.kd
        jy = (pay - pby) * j.kp + dvy * (speed + j.v0) * j.kd
        vx[a], vx[b] = vx[a] - jx * im[a], vx[b] + jx * im[b]
        vy[a], vy[b] = vy[a] - jy * im[a], vy[b] + jy * im[b]
        om[a] = om[a] - (rax * jy - ray * jx) * ii[a]
        om[b] = om[b] + (rbx * jy - rby * jx) * ii[b]
    return s._replace(vx=torch.stack(vx, 1), vy=torch.stack(vy, 1), om=torch.stack(om, 1))


def step(world: World, s: Bodies, collide) -> tuple:
    """One physics step; ``collide(s) -> Lanes`` is the world's collide."""
    s = integrate(world, s)
    con = collide(s)
    s = solve(world, s, con)
    return joints(world, s), con
