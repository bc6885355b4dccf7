"""Impulse-based contact resolution (the torch port of ``dynamics/impulses.py``).

The reference's impulse math over contacts with leading batch axes:

* restitution ``e = min(e1, e2)`` (or the mean);
* Baumgarte positional stabilization folded into the normal impulse
  (coefficient 0.3 over ``baumgarte_dt = 0.01``), with an optional slop
  and bias clamp;
* the effective mass ``1/m1 + 1/m2 + |r1|^2/I1 + |r2|^2/I2`` of the
  reference, or the textbook ``(r x n)^2`` lever arms;
* friction along the reference's ``v_rel + v_n n`` drag direction with
  its literal clamp, or the tangential Coulomb clamp;
* nothing applied when ``dot(pen, v_rel) < 0`` (bodies separating).

Everything returns velocity *deltas*, so the solver accumulates them
Jacobi-style or applies them in sequence (Gauss-Seidel).  Every maximum,
minimum and clip is JAX's (a tie splits the cotangent half and half,
``geometry.math._max_c``).
"""

from __future__ import annotations

import dataclasses

import torch

from parallax_tpu_torch.geometry.math import _max_c, _min_c, cross2, perpendicular_vector, safe_norm


@dataclasses.dataclass(frozen=True)
class ContactSolverConfig:
    """Static solver configuration."""

    baumgarte: float = 0.3
    baumgarte_dt: float = 0.01
    # positional-correction hygiene: a slop and a bias-velocity clamp keep
    # the Baumgarte term from turning deep penetration into exit velocity
    baumgarte_slop: float = 0.005
    baumgarte_max_bias: float = 0.5
    friction_mode: str = "tangent"  # "tangent" | "reference"
    restitution_mode: str = "min"  # "min" | "mean"
    lever_mode: str = "textbook"  # "textbook" | "reference"

    @classmethod
    def reference(cls) -> "ContactSolverConfig":
        """The reference simulator's formulas."""
        return cls(
            baumgarte_slop=0.0,
            baumgarte_max_bias=None,
            friction_mode="reference",
            restitution_mode="min",
            lever_mode="reference",
        )


DEFAULT_SOLVER = ContactSolverConfig()


def impulse_deltas(impulse, point, pos, inv_mass, inv_inertia):
    """``(dvel, domega)`` from applying ``impulse`` at world ``point``:
    ``v += J/m``, ``omega += (r x J)/I``.  All arguments broadcast."""
    torque = cross2(point - pos, impulse)
    return impulse * inv_mass[..., None], torque * inv_inertia


def contact_impulse(
    pen, point, active,
    pos_a, vel_a, omega_a, pos_b, vel_b, omega_b,
    inv_mass_a, inv_inertia_a, elasticity_a, friction_a,
    inv_mass_b, inv_inertia_b, elasticity_b, friction_b,
    config: ContactSolverConfig = DEFAULT_SOLVER,
):
    """Total impulse J applied to body B at ``point`` (body A receives -J).

    ``pen`` points from B toward A; the normal impulse scalar comes out
    negative for approaching bodies.  Returns ``(J [.., 2], applied [..]
    bool)``.
    """
    dtype = pen.dtype
    depth = safe_norm(pen, dim=-1)
    safe_depth = torch.where(depth == 0, 1.0, depth)
    normal = pen / safe_depth[..., None]

    v_ca = vel_a + perpendicular_vector(point - pos_a) * omega_a[..., None]
    v_cb = vel_b + perpendicular_vector(point - pos_b) * omega_b[..., None]
    v_rel = v_cb - v_ca
    v_n = torch.sum(v_rel * normal, dim=-1)

    if config.restitution_mode == "min":
        e = torch.minimum(elasticity_a, elasticity_b)
    else:
        e = (elasticity_a + elasticity_b) / 2

    r1 = point - pos_a
    r2 = point - pos_b
    if config.lever_mode == "reference":
        ang = torch.sum(r1**2, dim=-1) * inv_inertia_a + torch.sum(r2**2, dim=-1) * inv_inertia_b
    else:
        ang = cross2(r1, normal) ** 2 * inv_inertia_a + cross2(r2, normal) ** 2 * inv_inertia_b

    k = inv_mass_a + inv_mass_b + ang
    safe_k = torch.where(k == 0, 1.0, k)

    bias = config.baumgarte * _max_c(depth - config.baumgarte_slop, 0.0) / config.baumgarte_dt
    if config.baumgarte_max_bias is not None:
        bias = _min_c(bias, config.baumgarte_max_bias)
    j_n = (-(1.0 + e) * v_n - bias) / safe_k
    impulse = j_n[..., None] * normal

    mu = (friction_a + friction_b) / 2
    if config.friction_mode == "reference":
        vel_drag = v_rel + v_n[..., None] * normal
    else:
        vel_drag = v_rel - v_n[..., None] * normal
    vd_norm = safe_norm(vel_drag, dim=-1)
    vd_unit = vel_drag / torch.where(vd_norm == 0, 1.0, vd_norm)[..., None]
    if config.friction_mode == "reference":
        # the reference's literal clamp: with j_n < 0 its upper bound lies
        # below its lower one, and jnp.clip's order (maximum, then minimum)
        # returns j_n * mu
        j_d = torch.minimum(_max_c(-vd_norm / safe_k, 0.0), j_n * mu)
    else:
        # the Coulomb clamp |j_t| <= mu |j_n|
        j_d = torch.maximum(-vd_norm / safe_k, -mu * torch.abs(j_n))
    impulse = impulse + j_d[..., None] * vd_unit

    separating = torch.sum(pen * v_rel, dim=-1) < 0
    applied = active & ~separating & (k > 0)
    impulse = torch.where(applied[..., None], impulse, torch.zeros_like(impulse))
    return impulse.to(dtype), applied


def resolve_contact_deltas(
    pen, point, active,
    pos_a, vel_a, omega_a, pos_b, vel_b, omega_b,
    params_a, params_b,
    config: ContactSolverConfig = DEFAULT_SOLVER,
):
    """Velocity and angular deltas for both bodies from one contact.

    ``params_*`` are tuples ``(inv_mass, inv_inertia, elasticity,
    friction)``.  Returns ``((dvel_a, domega_a), (dvel_b, domega_b),
    applied)``.
    """
    im_a, ii_a, e_a, f_a = params_a
    im_b, ii_b, e_b, f_b = params_b
    J, applied = contact_impulse(
        pen, point, active,
        pos_a, vel_a, omega_a, pos_b, vel_b, omega_b,
        im_a, ii_a, e_a, f_a, im_b, ii_b, e_b, f_b,
        config,
    )
    dva, dwa = impulse_deltas(-J, point, pos_a, im_a, ii_a)
    dvb, dwb = impulse_deltas(J, point, pos_b, im_b, ii_b)
    return (dva, dwa), (dvb, dwb), applied
