"""Rigid-body integrators (the torch port of ``dynamics/integrator.py``).

The reference's explicit-Euler position update with forces applied as
velocity kicks, and the semi-implicit (symplectic) variant, over states
with leading batch axes.
"""

from __future__ import annotations

import torch

from parallax_tpu_torch.dynamics.bodies import BodyParams, BodyState


def integrate_explicit_euler(state: BodyState, dt) -> BodyState:
    """x += v dt; theta += omega dt."""
    return state._replace(pos=state.pos + state.vel * dt, angle=state.angle + state.omega * dt)


def apply_acceleration(state: BodyState, accel, dt, movable=None) -> BodyState:
    """v += a dt, masked to movable (finite-mass) bodies.

    ``accel`` broadcasts against ``[.., n, 2]``: pass e.g. ``[0, -g]``.
    """
    vel = state.vel
    dv = torch.as_tensor(accel, dtype=vel.dtype, device=vel.device).expand(vel.shape) * dt
    if movable is not None:
        dv = dv * movable[..., None]
    return state._replace(vel=vel + dv)


def integrate_symplectic_euler(state: BodyState, dt, accel=None, movable=None) -> BodyState:
    """Semi-implicit Euler: velocities first, then positions."""
    if accel is not None:
        state = apply_acceleration(state, accel, dt, movable)
    return integrate_explicit_euler(state, dt)


def movable_mask(params: BodyParams):
    """1.0 for finite-mass bodies, 0.0 for static ones."""
    return torch.isfinite(params.mass).to(params.mass.dtype)
