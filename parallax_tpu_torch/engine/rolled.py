"""Offset-rolled all-pairs physics for uniform-circle worlds (billiards), in torch.

The port of ``parallax_tpu/engine/rolled.py``: the billiards step for a
world of ``nb`` equal balls in a box of static walls, without a lane
table.

* Ball pairs by offset: lane ``(d, i)`` pairs ball ``i`` with ball
  ``(i + d) mod nb`` for ``d = 1..nb//2``, so every unordered pair appears
  once (for even ``nb`` half of the offset ``nb/2`` is masked off).  The
  partner's planes are ``torch.roll(plane, -d)`` and the partner's impulse
  is scattered back with ``torch.roll(delta, +d)``: whole ``[nb, B]``
  planes, no index tables.  For equal radii the circle-circle formulas are
  symmetric, so a lane whose A ball has the higher index gives the same
  impulse.
* Ball-wall lanes are ``[nb, B]`` planes too, one per static box.

The solve transcribes the lane engine's solve for worlds without 2-point
manifolds (Jacobi sums within each pass, in the JAX package's lane order:
the ball offsets, then the walls), and the contacts are
``engine.batched._cc_bm``/``_cb_bm``.  Plain torch on the caller's device:
the JAX package runs this as XLA, with no kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from parallax_tpu_torch.dynamics.impulses import ContactSolverConfig
from parallax_tpu_torch.engine.batched import ContactsBM, _cb_bm, _cc_bm, _SoA
from parallax_tpu_torch.geometry.math import _const, _max_c, _min_c
from parallax_tpu_torch.utils.device import static_tensor


@dataclasses.dataclass(frozen=True)
class RolledCircleWorld:
    """Static description of a uniform-circle world."""

    n_balls: int
    radius: float
    inv_mass: float
    inv_inertia: float
    e_ball: float  # pairwise restitution (min-combine of equal values)
    mu_ball: float
    walls_lb: Tuple[Tuple[float, float], ...]  # W axis-aligned boxes
    walls_ub: Tuple[Tuple[float, float], ...]
    e_wall: float  # min(e_ball, e_wall) applied at build
    mu_wall: float  # (mu_ball + mu_wall) / 2 applied at build
    dt: float
    gravity: Tuple[float, float]
    integrator: str
    iterations: int
    position_iterations: int
    contact: ContactSolverConfig

    @property
    def offsets(self):
        return range(1, self.n_balls // 2 + 1)

    def lane_valid(self, d: int) -> np.ndarray:
        """``[nb]`` static validity for offset ``d`` (even ``nb``: half of
        ``d = nb/2``, whose second half repeats its first)."""
        nb = self.n_balls
        if 2 * d == nb:
            return np.arange(nb) < nb // 2
        return np.ones(nb, bool)


def _roll(x, d):
    return torch.roll(x, d, dims=0)


def physics_rolled(world: RolledCircleWorld, s: _SoA) -> tuple[_SoA, ContactsBM]:
    """The full physics step (integrate, gravity, contacts, solve) on
    ``[n_bodies, B]`` planes.  Only the first ``n_balls`` rows move; the
    trailing rows (the static walls) are carried through untouched.
    Returns an empty ``ContactsBM`` (``[0, B]``: there is no lane table;
    billiards' post hook reads positions only)."""
    cfg = world.contact
    dt = world.dt
    nb = world.n_balls
    r = world.radius
    im = world.inv_mass
    ii = world.inv_inertia

    px, py = s.px[:nb], s.py[:nb]
    vx, vy = s.vx[:nb], s.vy[:nb]
    ang, om = s.angle[:nb], s.omega[:nb]

    gx, gy = world.gravity

    def integrate(px, py, ang, vx, vy, om):
        return px + vx * dt, py + vy * dt, ang + om * dt

    if world.integrator == "symplectic":
        vx = vx + gx * dt
        vy = vy + gy * dt
        px, py, ang = integrate(px, py, ang, vx, vy, om)
    else:
        px, py, ang = integrate(px, py, ang, vx, vy, om)
        vx = vx + gx * dt
        vy = vy + gy * dt

    # -- contact lanes ------------------------------------------------------
    # ball-ball: per offset d, lane i pairs (i, (i+d) mod nb)
    cc = []
    for d in world.offsets:
        pen_x, pen_y, pt_x, pt_y, active = _cc_bm(px, py, r, _roll(px, -d), _roll(py, -d), r)
        valid = static_tensor(world.lane_valid(d), px.device)[:, None]
        cc.append((pen_x, pen_y, pt_x, pt_y, active & valid))

    # ball-wall: W lanes of [nb, B] (A = ball, B = static box)
    cw = []
    for (lbx, lby), (ubx, uby) in zip(world.walls_lb, world.walls_ub):
        box = (_const(v, px.dtype) for v in (lbx, lby, ubx, uby))
        cw.append(_cb_bm(px, py, r, *box))

    # -- per-lane solver constants (the no-partner solve) -------------------
    e_bb = world.e_ball
    mu_bb = world.mu_ball
    e_bw = min(world.e_ball, world.e_wall)
    mu_bw = (world.mu_ball + world.mu_wall) / 2.0

    def lane_setup(pen_x, pen_y, pt_x, pt_y, active, pax, pay, pbx, pby, im_b, ii_b):
        d2 = pen_x * pen_x + pen_y * pen_y
        inv_d = torch.rsqrt(torch.where(d2 <= 0, 1.0, d2))
        depth = d2 * inv_d
        nx = torch.where(d2 == 0, 0.0, pen_x * inv_d)
        ny = torch.where(d2 == 0, 0.0, pen_y * inv_d)
        tx, ty = -ny, nx
        rax = pt_x - pax
        ray = pt_y - pay
        rbx = pt_x - pbx
        rby = pt_y - pby
        ran = rax * ny - ray * nx
        rbn = rbx * ny - rby * nx
        rat = rax * ty - ray * tx
        rbt = rbx * ty - rby * tx
        k_n = im + im_b + ii * ran * ran + ii_b * rbn * rbn
        k_t = im + im_b + ii * rat * rat + ii_b * rbt * rbt
        inv_kn = 1.0 / torch.where(k_n == 0, 1.0, k_n)
        inv_kt = 1.0 / torch.where(k_t == 0, 1.0, k_t)
        bias = cfg.baumgarte * _max_c(depth - cfg.baumgarte_slop, 0.0) / cfg.baumgarte_dt
        if cfg.baumgarte_max_bias is not None:
            bias = _min_c(bias, cfg.baumgarte_max_bias)
        bias = torch.where(active, bias, 0.0)
        return dict(nx=nx, ny=ny, tx=tx, ty=ty, rax=rax, ray=ray, rbx=rbx, rby=rby,
                    inv_kn=inv_kn, inv_kt=inv_kt, bias=bias, active=active,
                    im_b=im_b, ii_b=ii_b)

    lanes = []
    for d, (pen_x, pen_y, pt_x, pt_y, active) in zip(world.offsets, cc):
        L = lane_setup(pen_x, pen_y, pt_x, pt_y, active,
                       px, py, _roll(px, -d), _roll(py, -d), im, ii)
        L.update(d=d, e=e_bb, mu=mu_bb)
        lanes.append(L)
    for pen_x, pen_y, pt_x, pt_y, active in cw:
        L = lane_setup(pen_x, pen_y, pt_x, pt_y, active, px, py, 0.0, 0.0, 0.0, 0.0)
        L.update(d=0, e=e_bw, mu=mu_bw)
        lanes.append(L)

    def lane_rel_vel(L, vx, vy, om):
        """``(v_n, v_t)`` of a lane against the current ball velocity planes."""
        d = L["d"]
        vax = vx - L["ray"] * om
        vay = vy + L["rax"] * om
        if L["im_b"] == 0.0:
            vbx = torch.zeros_like(vax)
            vby = torch.zeros_like(vay)
        else:
            vxp, vyp, omp = _roll(vx, -d), _roll(vy, -d), _roll(om, -d)
            vbx = vxp - L["rby"] * omp
            vby = vyp + L["rbx"] * omp
        rx = vbx - vax
        ry = vby - vay
        return rx * L["nx"] + ry * L["ny"], rx * L["tx"] + ry * L["ty"]

    # restitution targets from the pre-solve velocities
    split = world.position_iterations > 0
    for L in lanes:
        v_n0, _ = lane_rel_vel(L, vx, vy, om)
        rest = torch.where(v_n0 > 0, L["e"] * _max_c(v_n0, 0.0), 0.0)
        L["v_n0"] = v_n0
        L["target"] = torch.where(L["active"], rest if split else rest + L["bias"], 0.0)

    def lane_deltas(L, dj_n, dj_t):
        """The velocity deltas of a lane's impulse deltas: the A side at
        lane index i, the B side rolled onto ball (i + d)."""
        jx = dj_n * L["nx"] + dj_t * L["tx"]
        jy = dj_n * L["ny"] + dj_t * L["ty"]
        dvax = jx * im
        dvay = jy * im
        dwa = (L["rax"] * jy - L["ray"] * jx) * ii
        if L["im_b"] == 0.0:
            return dvax, dvay, dwa
        dvbx = _roll(-jx * L["im_b"], L["d"])
        dvby = _roll(-jy * L["im_b"], L["d"])
        dwb = _roll(-(L["rbx"] * jy - L["rby"] * jx) * L["ii_b"], L["d"])
        return dvax + dvbx, dvay + dvby, dwa + dwb

    def zeros():
        return torch.zeros_like(px)

    jn = [zeros() for _ in lanes]
    jt = [zeros() for _ in lanes]
    for it in range(world.iterations):
        # the normal pass (Jacobi within the pass)
        dvx, dvy, dom = zeros(), zeros(), zeros()
        for k, L in enumerate(lanes):
            v_n = L["v_n0"] if it == 0 else lane_rel_vel(L, vx, vy, om)[0]
            rhs = v_n + L["target"]
            if it == 0:
                jn_new = _max_c(rhs * L["inv_kn"], 0.0)
            else:
                jn_new = _max_c(jn[k] + rhs * L["inv_kn"], 0.0)
            jn_new = torch.where(L["active"], jn_new, 0.0)
            ax, ay, aw = lane_deltas(L, jn_new - jn[k], zeros())
            dvx, dvy, dom = dvx + ax, dvy + ay, dom + aw
            jn[k] = jn_new
        vx, vy, om = vx + dvx, vy + dvy, om + dom

        # the friction pass on the post-normal velocities
        dvx, dvy, dom = zeros(), zeros(), zeros()
        for k, L in enumerate(lanes):
            _, v_t = lane_rel_vel(L, vx, vy, om)
            jt_new = v_t * L["inv_kt"] if it == 0 else jt[k] + v_t * L["inv_kt"]
            lim = L["mu"] * jn[k]
            # jnp.clip(jt_new, -lim, lim), with its half cotangent at a tie
            jt_new = torch.minimum(torch.maximum(jt_new, -lim), lim)
            jt_new = torch.where(L["active"], jt_new, 0.0)
            ax, ay, aw = lane_deltas(L, zeros(), jt_new - jt[k])
            dvx, dvy, dom = dvx + ax, dvy + ay, dom + aw
            jt[k] = jt_new
        vx, vy, om = vx + dvx, vy + dvy, om + dom

    if split:
        pvx, pvy, pom = zeros(), zeros(), zeros()
        pj = [zeros() for _ in lanes]
        for it in range(world.position_iterations):
            dvx, dvy, dom = zeros(), zeros(), zeros()
            for k, L in enumerate(lanes):
                if it == 0:
                    rhs = L["bias"]
                else:
                    v_n, _ = lane_rel_vel(L, pvx, pvy, pom)
                    rhs = v_n + L["bias"]
                pj_new = torch.where(
                    L["active"],
                    _max_c((0.0 if it == 0 else pj[k]) + rhs * L["inv_kn"], 0.0),
                    0.0,
                )
                ax, ay, aw = lane_deltas(L, pj_new - pj[k], zeros())
                dvx, dvy, dom = dvx + ax, dvy + ay, dom + aw
                pj[k] = pj_new
            pvx, pvy, pom = pvx + dvx, pvy + dvy, pom + dom
        px = px + pvx * dt
        py = py + pvy * dt
        ang = ang + pom * dt

    out = _SoA(*(
        torch.cat([mine, rest[nb:]])
        for mine, rest in zip((px, py, vx, vy, ang, om), s)
    ))
    z = px.new_zeros((0, px.shape[-1]))
    con = ContactsBM(pen_x=z, pen_y=z, pt_x=z, pt_y=z,
                     active=torch.zeros((0, px.shape[-1]), dtype=torch.bool, device=px.device),
                     weight=z)
    return out, con
