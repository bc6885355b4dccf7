"""Sequential-impulse contact solver with 2x2 manifold block solving (the
torch port of ``dynamics/block_solver.py``).

Per contact lane an accumulated normal impulse (clamped >= 0) and friction
impulse (Coulomb-clamped against the accumulated normal), with the two
lanes of a polygon-face manifold solved jointly as a 2x2 linear
complementarity block.  Restitution uses the pre-solve approach velocity,
captured once; the Baumgarte bias runs on pseudo-velocities that move
positions only (split impulse).  Every block solves against the current
velocities each iteration and the deltas are summed per body (block
Jacobi), over contacts with leading batch axes.

Conventions: ``n = pen/|pen|`` points B -> A; the approach speed
``v_n = (v_B - v_A).n`` is positive when closing; a normal impulse
``j >= 0`` is applied as ``+j n`` to A and ``-j n`` to B.
"""

from __future__ import annotations

import numpy as np
import torch

from parallax_tpu_torch.dynamics.bodies import BodyParams, BodyState
from parallax_tpu_torch.dynamics.impulses import DEFAULT_SOLVER, ContactSolverConfig
from parallax_tpu_torch.geometry.contacts import Contact
from parallax_tpu_torch.geometry.math import _max_c, _min_c, perpendicular_vector, safe_norm
from parallax_tpu_torch.utils.device import static_tensor


def _velocity_at(vel, omega, point, pos):
    return vel + perpendicular_vector(point - pos) * omega[..., None]


def segment_sum(x, idx, n: int, dim: int):
    """``jax.ops.segment_sum`` along ``dim``: ``out[.., k, ..]`` sums the
    slices of ``x`` whose ``idx`` is ``k`` (``n`` segments)."""
    shape = list(x.shape)
    shape[dim] = n
    return x.new_zeros(shape).index_add(dim, idx, x)


def solve_contacts(
    state: BodyState,
    params: BodyParams,
    contacts: Contact,
    body_a: np.ndarray,
    body_b: np.ndarray,
    partner: np.ndarray,
    iterations: int = 8,
    position_iterations: int = 3,
    dt: float = 0.01,
    order: str = "jacobi",
    restitution_threshold: float = 0.0,
    config: ContactSolverConfig = DEFAULT_SOLVER,
) -> BodyState:
    """Accumulated sequential impulses over the contact buffer ``[.., C]``.

    ``partner[c]`` is the other lane of c's 2-point manifold, or -1 for a
    singleton lane; manifold pairs are solved as one 2x2 block.  ``order``
    is accepted and unused, as in the JAX package: the sweep is block
    Jacobi.
    """
    del order
    C = len(body_a)
    if C == 0:
        return state
    partner = np.asarray(partner)
    dev = state.pos.device
    n_bodies = state.pos.shape[-2]
    ia = static_tensor(body_a, dev)
    ib = static_tensor(body_b, dev)
    has_partner = partner >= 0
    ip = static_tensor(np.where(has_partner, partner, np.arange(C)), dev)
    is_block_lead = static_tensor(has_partner & (partner > np.arange(C)), dev)
    has_partner_t = static_tensor(has_partner, dev)

    im_a, ii_a = params.inv_mass[ia], params.inv_inertia[ia]
    im_b, ii_b = params.inv_mass[ib], params.inv_inertia[ib]
    if config.restitution_mode == "min":
        e = torch.minimum(params.elasticity[ia], params.elasticity[ib])
    else:
        e = (params.elasticity[ia] + params.elasticity[ib]) / 2
    mu = (params.friction[ia] + params.friction[ib]) / 2

    pen = contacts.penetration
    point = contacts.point
    active = contacts.active
    depth = safe_norm(pen, dim=-1)
    normal = pen / torch.where(depth == 0, 1.0, depth)[..., None]
    tangent = perpendicular_vector(normal)

    pos_a = state.pos[..., ia, :]
    pos_b = state.pos[..., ib, :]
    r_a = point - pos_a
    r_b = point - pos_b
    # effective masses
    ran = r_a[..., 0] * normal[..., 1] - r_a[..., 1] * normal[..., 0]  # r_a x n
    rbn = r_b[..., 0] * normal[..., 1] - r_b[..., 1] * normal[..., 0]
    rat = r_a[..., 0] * tangent[..., 1] - r_a[..., 1] * tangent[..., 0]
    rbt = r_b[..., 0] * tangent[..., 1] - r_b[..., 1] * tangent[..., 0]
    k_n = im_a + im_b + ii_a * ran**2 + ii_b * rbn**2
    k_t = im_a + im_b + ii_a * rat**2 + ii_b * rbt**2
    # cross-coupling with the partner lane (same normal within a manifold)
    k_np = im_a + im_b + ii_a * ran * ran[..., ip] + ii_b * rbn * rbn[..., ip]
    k_tp = im_a + im_b + ii_a * rat * rat[..., ip] + ii_b * rbt * rbt[..., ip]

    inv_kn = 1.0 / torch.where(k_n == 0, 1.0, k_n)
    inv_kt = 1.0 / torch.where(k_t == 0, 1.0, k_t)

    def v_n_at(vel, omega):
        va = _velocity_at(vel[..., ia, :], omega[..., ia], point, pos_a)
        vb = _velocity_at(vel[..., ib, :], omega[..., ib], point, pos_b)
        rel = vb - va
        return torch.sum(rel * normal, dim=-1), torch.sum(rel * tangent, dim=-1)

    # restitution target from the pre-solve approach speed; Baumgarte bias
    v_n0, _ = v_n_at(state.vel, state.omega)
    bias = config.baumgarte * _max_c(depth - config.baumgarte_slop, 0.0) / config.baumgarte_dt
    if config.baumgarte_max_bias is not None:
        bias = _min_c(bias, config.baumgarte_max_bias)
    rest = e * _max_c(v_n0, 0.0)
    rest = torch.where(v_n0 > restitution_threshold, rest, 0.0)
    # split impulse: the bias runs on pseudo-velocities that move positions
    # only, so the velocity solve sees restitution alone
    split = position_iterations > 0
    target = rest if split else rest + bias  # want v_n' = -target
    target = torch.where(active, target, 0.0)
    bias = torch.where(active, bias, 0.0)

    def apply(vel, omega, dj_n, dj_t):
        """Sum the lanes' impulse deltas into the bodies' velocities."""
        imp = dj_n[..., None] * normal + dj_t[..., None] * tangent  # on A
        dva = imp * im_a[..., None]
        dwa = (r_a[..., 0] * imp[..., 1] - r_a[..., 1] * imp[..., 0]) * ii_a
        dvb = -imp * im_b[..., None]
        dwb = -(r_b[..., 0] * imp[..., 1] - r_b[..., 1] * imp[..., 0]) * ii_b
        dvel = segment_sum(dva, ia, n_bodies, -2) + segment_sum(dvb, ib, n_bodies, -2)
        dom = segment_sum(dwa, ia, n_bodies, -1) + segment_sum(dwb, ib, n_bodies, -1)
        return vel + dvel, omega + dom

    # block-solve only when both manifold lanes are active
    blockable = has_partner_t & active & active[..., ip]

    def normal_pass(vel, omega, jn):
        v_n, _ = v_n_at(vel, omega)
        rhs = v_n + target  # residual: want this driven to 0 with jn >= 0

        # singleton (1x1) update: v' = v - k dj  =>  dj = rhs / k
        jn_new_single = _max_c(jn + rhs * inv_kn, 0.0)

        # 2x2 block update (the lead lane solves for itself and its partner)
        rhs_p = rhs[..., ip]
        jn_p = jn[..., ip]
        k_p = k_n[..., ip]
        inv_kp = 1.0 / torch.where(k_p == 0, 1.0, k_p)
        # case 1: both active -> solve K x = b for the new accumulated
        # impulses, with b = K j_acc + rhs (the post-residual is zero)
        det = k_n * k_p - k_np * k_np
        safe_det = torch.where(torch.abs(det) < 1e-12, 1.0, det)
        b0 = k_n * jn + k_np * jn_p + rhs
        b1 = k_np * jn + k_p * jn_p + rhs_p
        x0_full = (k_p * b0 - k_np * b1) / safe_det
        x1_full = (k_n * b1 - k_np * b0) / safe_det
        ok_full = (x0_full >= 0) & (x1_full >= 0) & (torch.abs(det) >= 1e-12)
        # case 2: partner impulse zero -> 1D solve for self
        x0_c2 = _max_c(b0 * inv_kn, 0.0)
        post_r1_c2 = k_np * x0_c2 - b1  # the partner's residual must be >= 0
        ok_c2 = (x0_c2 >= 0) & (post_r1_c2 >= -1e-9)
        # case 3: self zero -> partner 1D
        x1_c3 = _max_c(b1 * inv_kp, 0.0)
        post_r0_c3 = k_np * x1_c3 - b0
        ok_c3 = (x1_c3 >= 0) & (post_r0_c3 >= -1e-9)

        x0 = torch.where(ok_full, x0_full, torch.where(ok_c2, x0_c2, 0.0))
        x1 = torch.where(ok_full, x1_full, torch.where(ok_c2, 0.0, torch.where(ok_c3, x1_c3, 0.0)))

        # the lead lane writes both lanes; a partner (non-lead) lane takes
        # the value its lead wrote for it
        jn_new_block = torch.where(is_block_lead, x0, x1[..., ip])
        jn_new = torch.where(blockable, jn_new_block, jn_new_single)
        jn_new = torch.where(active, jn_new, 0.0)
        vel, omega = apply(vel, omega, jn_new - jn, torch.zeros_like(jn))
        return vel, omega, jn_new

    def friction_pass(vel, omega, jn, jt):
        """Friction on post-normal velocities; a coupled 2x2 for manifold
        lanes, then the Coulomb clamp."""
        _, v_t = v_n_at(vel, omega)
        jt_single = jt + v_t * inv_kt
        k_tpd = k_t[..., ip]
        det_t = k_t * k_tpd - k_tp * k_tp
        # relative threshold: face manifolds have identical tangential
        # Jacobians on both points (singular); least-norm split then
        ok_det_t = torch.abs(det_t) >= 1e-5 * k_t * k_tpd
        safe_det_t = torch.where(ok_det_t, det_t, 1.0)
        kt_sum = k_t + k_tp
        jt_split = jt + v_t / torch.where(kt_sum == 0, 1.0, kt_sum)
        v_t_p = v_t[..., ip]
        jt_p = jt[..., ip]
        bt0 = k_t * jt + k_tp * jt_p + v_t
        bt1 = k_tp * jt + k_tpd * jt_p + v_t_p
        xt0 = (k_tpd * bt0 - k_tp * bt1) / safe_det_t
        xt1 = (k_t * bt1 - k_tp * bt0) / safe_det_t
        jt_block = torch.where(is_block_lead, xt0, xt1[..., ip])
        jt_block = torch.where(ok_det_t, jt_block, jt_split)
        jt_new = torch.where(blockable, jt_block, jt_single)
        lim = mu * jn
        jt_new = torch.minimum(torch.maximum(jt_new, -lim), lim)  # jnp.clip
        jt_new = torch.where(active, jt_new, 0.0)
        vel, omega = apply(vel, omega, torch.zeros_like(jt), jt_new - jt)
        return vel, omega, jt_new

    vel, omega = state.vel, state.omega
    jn = torch.zeros(active.shape, dtype=vel.dtype, device=dev)
    jt = torch.zeros(active.shape, dtype=vel.dtype, device=dev)
    for _ in range(iterations):
        vel, omega, jn = normal_pass(vel, omega, jn)
        vel, omega, jt = friction_pass(vel, omega, jn, jt)
    state = state._replace(vel=vel, omega=omega)

    if split:
        # positional pass: the same machinery on zero pseudo-velocities with
        # the bias as the sole target, folded into positions
        def pseudo_pass(pvel, pomega, pj):
            v_n, _ = v_n_at(pvel, pomega)
            rhs = v_n + bias
            pj_new = _max_c(pj + rhs * inv_kn, 0.0)
            pj_new = torch.where(active, pj_new, 0.0)
            pvel, pomega = apply(pvel, pomega, pj_new - pj, torch.zeros_like(pj))
            return pvel, pomega, pj_new

        pvel = torch.zeros_like(vel)
        pomega = torch.zeros_like(omega)
        pj = torch.zeros_like(jn)
        for _ in range(position_iterations):
            pvel, pomega, pj = pseudo_pass(pvel, pomega, pj)
        state = state._replace(pos=state.pos + pvel * dt, angle=state.angle + pomega * dt)
    return state
