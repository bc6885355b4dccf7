"""Bouncer: the smallest env on the generic plane-space loop (torch).

The port of ``parallax_tpu/envs/bouncer.py``'s batched path: ``n_balls``
elastic circles in a walled box with zero gravity; the agent thrusts ball
0, and the reward is staying close to the arena centre while moving.  The
env defines only its world, a thrust hook and a reward hook; everything
else comes from ``envs/plane_env.PlaneEnvMixin``.  Its pair groups are
ball-ball (``cc``) and ball-wall (``cb``); the contact solve runs as the
CUDA kernel when the world's tensors are on a GPU
(``WorldConfig.use_cuda_solver``, the twin of ``use_pallas_solver``).
The per-world ``reset_fn``/``step_fn`` (states with any leading batch
axes, ``envs/base.py``) step through ``World.step``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from parallax_tpu_torch.dynamics.bodies import BodyState
from parallax_tpu_torch.engine.batched import _clip_c
from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
from parallax_tpu_torch.envs.base import BatchedEnvironmentMixin, Environment, TimeStep
from parallax_tpu_torch.envs.plane_env import PlaneEnvMixin, init_planes_of
from parallax_tpu_torch.geometry.math import safe_norm
from parallax_tpu_torch.geometry.shapes import box, circle
from parallax_tpu_torch.utils.device import resolve as resolve_device

HALF = 2.0  # arena half-extent
WALL = 0.3
BALL_R = 0.18


@dataclasses.dataclass(frozen=True)
class BouncerConfig:
    n_balls: int = 6
    dt: float = 0.02
    max_steps: int = 1000
    accel: float = 6.0
    elasticity: float = 0.9
    friction: float = 0.2
    control_cost: float = 0.01


class BouncerState(NamedTuple):
    bodies: BodyState  # [B, n, ...]
    t: torch.Tensor  # [B] int32
    key: torch.Tensor  # [B, 2] int64 holding uint32 key words


class Bouncer(PlaneEnvMixin, BatchedEnvironmentMixin, Environment):
    """Batched Bouncer on ``device`` (the GPU unless the caller asks for the
    CPU); see the module docstring."""

    def __init__(self, config: BouncerConfig = BouncerConfig(), device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        n = config.n_balls
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
        balls = [
            BodyDef(
                shapes=[circle(BALL_R)],
                mass=1.0,
                inertia=0.1,
                position=(np.cos(a) * HALF * 0.5, np.sin(a) * HALF * 0.5),
                velocity=(-np.sin(a) * 0.5, np.cos(a) * 0.5),
                elasticity=config.elasticity,
                friction=config.friction,
                name=f"ball{i}",
            )
            for i, a in enumerate(ang)
        ]
        h, w = HALF, WALL
        walls = [
            BodyDef(shapes=[box(lo, hi)], mass=np.inf, inertia=np.inf,
                    elasticity=config.elasticity, name=nm)
            for nm, (lo, hi) in {
                "wall_b": ((-h - w, -h - w), (h + w, -h)),
                "wall_t": ((-h - w, h), (h + w, h + w)),
                "wall_l": ((-h - w, -h), (-h, h)),
                "wall_r": ((h, -h), (h + w, h)),
            }.items()
        ]
        wc = WorldConfig(dt=config.dt, gravity=(0.0, 0.0),
                         integrator="symplectic", use_cuda_solver=True)
        self.world, self._init_bodies = World.build(balls + walls, wc, device=self.device)
        self._init_planes = init_planes_of(self._init_bodies)

    @property
    def action_size(self) -> int:
        return 2

    @property
    def observation_size(self) -> int:
        return 6 * self.world.n_bodies

    def reset_fn(self, key) -> BouncerState:
        """``key`` ``[..., 2]`` -> the initial state; each world keeps its
        key (``reset_fn_batch`` is this on ``[B, 2]`` keys)."""
        shape = key.shape[:-1]
        bodies = BodyState(
            *(x.expand(shape + x.shape).contiguous() for x in self._init_bodies)
        )
        return BouncerState(
            bodies=bodies,
            t=torch.zeros(shape, dtype=torch.int32, device=key.device),
            key=key.contiguous(),
        )

    def observe(self, states: BouncerState):
        """``[..., 6n]``: x, y, vx, vy, angle and omega of every body."""
        b = states.bodies
        return torch.cat([b.pos[..., 0], b.pos[..., 1], b.vel[..., 0],
                          b.vel[..., 1], b.angle, b.omega], dim=-1)

    def step_fn(self, state: BouncerState, action):
        cfg = self.config
        shape = state.t.shape
        a = torch.as_tensor(action, dtype=torch.float32, device=state.t.device)
        a = _clip_c(a.reshape(shape + (2,)), -1.0, 1.0)
        vel = state.bodies.vel.clone()
        vel[..., 0, :] = vel[..., 0, :] + a * cfg.accel * cfg.dt
        b, _ = self.world.step(state.bodies._replace(vel=vel))
        new_state = state._replace(bodies=b, t=state.t + 1)
        d = safe_norm(b.pos[..., 0, :])
        reward = -d * cfg.dt - cfg.control_cost * torch.sum(a * a, dim=-1)
        return new_state, TimeStep(
            obs=self.observe(new_state),
            reward=reward,
            terminated=torch.zeros(shape, dtype=torch.bool, device=state.t.device),
            truncated=new_state.t >= cfg.max_steps,
            info={},
        )

    # -- the generic plane-space hooks: thrust + reward, nothing else -------

    def plane_make_state(self, bodies, aux, t, key) -> BouncerState:
        return BouncerState(bodies=bodies, t=t, key=key)

    def plane_pre(self, s, aux, actions):
        cfg = self.config
        a = _clip_c(actions.to(torch.float32).reshape(-1, 2), -1.0, 1.0)

        def add_row0(x, d):
            return torch.cat([(x[0] + d)[None], x[1:]])

        return s._replace(
            vx=add_row0(s.vx, a[:, 0] * cfg.accel * cfg.dt),
            vy=add_row0(s.vy, a[:, 1] * cfg.accel * cfg.dt),
        )

    def plane_post(self, s, aux, con, actions, t_new):
        cfg = self.config
        a = _clip_c(actions.to(torch.float32).reshape(-1, 2), -1.0, 1.0)
        d = safe_norm(torch.stack([s.px[0], s.py[0]], dim=-1))
        reward = -d * cfg.dt - cfg.control_cost * torch.sum(a * a, dim=-1)
        terminated = torch.zeros(t_new.shape, dtype=torch.bool, device=t_new.device)
        return s, aux, reward, terminated, {}
