"""Struct-of-arrays rigid-body state and parameters, as torch tensors.

Infinite masses are allowed (static bodies); ``inv_mass`` and
``inv_inertia`` are then exactly 0, so static bodies need no branches in
the inverse-mass terms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from parallax_tpu_torch.geometry.math import perpendicular_vector


class BodyState(NamedTuple):
    """Dynamic per-body state, shape ``[.., n_bodies, ...]``."""

    pos: torch.Tensor  # [.., n, 2]
    vel: torch.Tensor  # [.., n, 2]
    angle: torch.Tensor  # [.., n]
    omega: torch.Tensor  # [.., n]

    @property
    def n_bodies(self) -> int:
        return self.pos.shape[-2]

    @staticmethod
    def zeros(n: int, dtype=torch.float32, device=None) -> "BodyState":
        return BodyState(
            pos=torch.zeros((n, 2), dtype=dtype, device=device),
            vel=torch.zeros((n, 2), dtype=dtype, device=device),
            angle=torch.zeros((n,), dtype=dtype, device=device),
            omega=torch.zeros((n,), dtype=dtype, device=device),
        )

    def velocity_at(self, point, index=None):
        """Rigid-body velocity of a world-frame ``point`` attached to body
        ``index`` (or to every body when None)."""
        if index is None:
            pos, vel, omega = self.pos, self.vel, self.omega
        else:
            pos, vel, omega = self.pos[..., index, :], self.vel[..., index, :], self.omega[..., index]
        return vel + perpendicular_vector(point - pos) * omega[..., None]


class BodyParams(NamedTuple):
    """Inertial and material parameters, shape ``[n_bodies]`` float32.

    ``mass`` and ``inertia`` may be ``inf`` (static bodies)."""

    mass: torch.Tensor
    inertia: torch.Tensor
    elasticity: torch.Tensor
    friction: torch.Tensor

    @property
    def inv_mass(self):
        return 1.0 / self.mass

    @property
    def inv_inertia(self):
        return 1.0 / self.inertia

    @staticmethod
    def make(mass, inertia, elasticity=None, friction=None, device=None) -> "BodyParams":
        """Float32 parameters; elasticity and friction default to 1."""
        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        mass = f32(mass)
        n = mass.shape[-1]
        return BodyParams(
            mass=mass,
            inertia=f32(inertia),
            elasticity=f32(elasticity) if elasticity is not None else f32([1.0] * n),
            friction=f32(friction) if friction is not None else f32([1.0] * n),
        )
