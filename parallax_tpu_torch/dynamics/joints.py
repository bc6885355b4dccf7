"""Spring-damper positional joints (the torch port of ``dynamics/joints.py``).

Each joint pins a local anchor on body A to a local anchor on body B with
the impulse law ``J = dp * kp + dv * (|dv| + v0) * kd``, applied as -J to
A and +J to B at the world anchors.  :func:`apply_joints` is the
per-world solve over states with leading batch axes: ``"gauss_seidel"``
applies the joints in sequence, each seeing the velocities the previous
one left (the reference's order), ``"jacobi"`` all at once.  World
anchors come from the poses at entry.  The batched step's solve is
``engine.batched.apply_joints_bm``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from parallax_tpu_torch.dynamics.bodies import BodyParams, BodyState
from parallax_tpu_torch.dynamics.impulses import impulse_deltas
from parallax_tpu_torch.geometry.math import perpendicular_vector, rotate, safe_norm
from parallax_tpu_torch.utils.device import static_tensor


class Joints(NamedTuple):
    """Static joint table: float32 tensors ``[J, ...]`` plus body tuples."""

    anchor_a: torch.Tensor  # [J, 2] local anchor on body_a
    anchor_b: torch.Tensor  # [J, 2] local anchor on body_b
    kp: torch.Tensor  # [J] position gain
    kd: torch.Tensor  # [J] velocity gain
    v0: torch.Tensor  # [J] velocity-law offset
    body_a: tuple
    body_b: tuple

    @property
    def n_joints(self) -> int:
        return len(self.body_a)

    @staticmethod
    def make(body_a, body_b, anchor_a, anchor_b, kp=1.0, kd=0.05, v0=0.1) -> "Joints":
        J = len(body_a)

        def gain(x):
            return torch.from_numpy(
                np.broadcast_to(np.asarray(x, np.float32), (J,)).copy()
            )

        return Joints(
            anchor_a=torch.from_numpy(np.asarray(anchor_a, np.float32).reshape(J, 2)),
            anchor_b=torch.from_numpy(np.asarray(anchor_b, np.float32).reshape(J, 2)),
            kp=gain(kp),
            kd=gain(kd),
            v0=gain(v0),
            body_a=tuple(int(b) for b in body_a),
            body_b=tuple(int(b) for b in body_b),
        )

    @staticmethod
    def empty() -> "Joints":
        return Joints.make([], [], np.zeros((0, 2)), np.zeros((0, 2)))

    def to(self, device) -> "Joints":
        return self._replace(
            anchor_a=self.anchor_a.to(device),
            anchor_b=self.anchor_b.to(device),
            kp=self.kp.to(device),
            kd=self.kd.to(device),
            v0=self.v0.to(device),
        )


def _world_anchors(state: BodyState, joints: Joints):
    ia = list(joints.body_a)
    ib = list(joints.body_b)
    pa = state.pos[..., ia, :] + rotate(joints.anchor_a, state.angle[..., ia])
    pb = state.pos[..., ib, :] + rotate(joints.anchor_b, state.angle[..., ib])
    return pa, pb


def _joint_impulse(pa, pb, pos_a, pos_b, vel_a, vel_b, omega_a, omega_b, kp, kd, v0):
    """The impulse law at world anchors ``pa``, ``pb`` of bodies moving
    at ``(vel, omega)``."""
    va = vel_a + perpendicular_vector(pa - pos_a) * omega_a[..., None]
    vb = vel_b + perpendicular_vector(pb - pos_b) * omega_b[..., None]
    dv = va - vb
    dvn = safe_norm(dv, dim=-1, keepdim=True)
    return (pa - pb) * kp[..., None] + dv * (dvn + v0[..., None]) * kd[..., None]


def apply_joints(
    state: BodyState,
    params: BodyParams,
    joints: Joints,
    mode: str = "gauss_seidel",
    iterations: int = 1,
) -> BodyState:
    """Apply all joint impulses; returns the state with updated velocities."""
    if joints.n_joints == 0:
        return state
    pa, pb = _world_anchors(state, joints)  # [.., J, 2]
    inv_mass, inv_inertia = params.inv_mass, params.inv_inertia

    if mode == "jacobi":
        ia = static_tensor(joints.body_a, state.pos.device)
        ib = static_tensor(joints.body_b, state.pos.device)
        pos_a, pos_b = state.pos[..., ia, :], state.pos[..., ib, :]
        for _ in range(iterations):
            J = _joint_impulse(pa, pb, pos_a, pos_b, state.vel[..., ia, :], state.vel[..., ib, :],
                               state.omega[..., ia], state.omega[..., ib],
                               joints.kp, joints.kd, joints.v0)
            dva, dwa = impulse_deltas(-J, pa, pos_a, inv_mass[ia], inv_inertia[ia])
            dvb, dwb = impulse_deltas(J, pb, pos_b, inv_mass[ib], inv_inertia[ib])
            state = state._replace(
                vel=state.vel.index_add(-2, ia, dva).index_add(-2, ib, dvb),
                omega=state.omega.index_add(-1, ia, dwa).index_add(-1, ib, dwb),
            )
        return state

    if mode != "gauss_seidel":
        raise ValueError(f"unknown joint mode {mode!r}")
    # gauss_seidel: the joints in table order, each on the velocities the
    # previous one left; the bodies' columns are carried apart, so each
    # joint touches only its two bodies
    vel = list(state.vel.unbind(-2))
    omega = list(state.omega.unbind(-1))
    pos = state.pos.unbind(-2)
    for _ in range(iterations):
        for j, (a, b) in enumerate(zip(joints.body_a, joints.body_b)):
            paj, pbj = pa[..., j, :], pb[..., j, :]
            J = _joint_impulse(paj, pbj, pos[a], pos[b], vel[a], vel[b], omega[a], omega[b],
                               joints.kp[j], joints.kd[j], joints.v0[j])
            dva, dwa = impulse_deltas(-J, paj, pos[a], inv_mass[a], inv_inertia[a])
            dvb, dwb = impulse_deltas(J, pbj, pos[b], inv_mass[b], inv_inertia[b])
            vel[a] = vel[a] + dva
            vel[b] = vel[b] + dvb
            omega[a] = omega[a] + dwa
            omega[b] = omega[b] + dwb
    return state._replace(vel=torch.stack(vel, -2), omega=torch.stack(omega, -1))
