"""RoboCup SSL field on the generic plane-space loop (torch).

The port of ``parallax_tpu/envs/robocup.py``'s batched path: a 10.4 x 7.4
field with a 9 x 6 play area, two goals of three thin boxes each, a ball
(a circle of radius 0.066) and ``n_robots_per_team`` circular robots a
team, driven by per-robot velocity commands (vx, vy, omega) under an
acceleration limit.  Blue (robots ``0..N-1``) attacks the yellow goal at
-x; the reward, from blue's side, is +-1 for a goal plus a small term for
the ball's progress toward -x.  A goal terminates the episode.

The field is an *area* body: it makes containment lanes (``area_cb``) that
keep the ball and the robots inside it.  The play area only marks the
bounds and collides with nothing (the collision filter ``(1, j)``).  So the
world's pair groups are ``cc`` (ball and robots), ``cb`` (against the goal
boxes) and ``area_cb`` (inside the field), one lane a pair.  The contact
solve runs as the CUDA kernel on a GPU (``WorldConfig.use_cuda_solver``);
``RoboCupConfig(use_cuda_fused=True)``, the twin of ``use_pallas_fused``,
runs the whole step as the fused kernel and trains through its reverse
pass (``ops/fused_step.py``).

Not ported: the per-world ``reset_fn``/``step_fn``, ``RoboCupJudge`` and
``make_world_forward``, and the reference-parity knobs
``narrowphase="gjk_epa"`` and ``solver_mode != "block"``, which raise
(ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from parallax_tpu_torch.dynamics.bodies import BodyState
from parallax_tpu_torch.engine.batched import _clip_c, _SoA, check_batched_support
from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
from parallax_tpu_torch.envs.base import Environment
from parallax_tpu_torch.envs.plane_env import PlaneEnvMixin, init_planes_of
from parallax_tpu_torch.geometry.shapes import box, circle
from parallax_tpu_torch.utils import prng
from parallax_tpu_torch.utils.device import resolve as resolve_device

FIELD_DIM = (10.4, 7.4)
PLAY_AREA = (9.0, 6.0)
GOAL_DIM = (0.2, 1.0)
GOAL_WALL = 0.01
BALL_RADIUS = 0.022 * 3


def _goal_boxes(side: int):
    """Three thin boxes forming one goal: side=-1 the yellow goal at -x,
    side=+1 the blue goal at +x (its mirror)."""
    lo = np.array([-PLAY_AREA[0] / 2 - GOAL_DIM[0], -GOAL_DIM[1] / 2])
    hi = np.array([-PLAY_AREA[0] / 2, GOAL_DIM[1] / 2])
    walls = [
        (lo, lo + np.array([GOAL_WALL, GOAL_DIM[1]])),  # back wall
        (lo + np.array([GOAL_WALL, 0.0]), lo + np.array([GOAL_DIM[0], GOAL_WALL])),
        (hi - np.array([GOAL_DIM[0], GOAL_WALL]), hi),  # top wall
    ]
    if side > 0:
        walls = [((-u[0], l[1]), (-l[0], u[1])) for (l, u) in walls]
    return [box(l, u) for (l, u) in walls]


@dataclasses.dataclass(frozen=True)
class RoboCupConfig:
    n_robots_per_team: int = 3
    dt: float = 0.01
    max_steps: int = 2000
    robot_radius: float = 0.09
    robot_mass: float = 2.5
    robot_inertia: float = 0.02
    robot_max_speed: float = 3.0
    robot_max_accel: float = 4.0
    robot_max_omega: float = 10.0
    ball_damping: float = 0.995  # rolling friction per step
    goal_reward: float = 1.0
    shaping_coef: float = 0.01
    solver_mode: str = "block"  # the batched path runs "block" only
    solver_iterations: int = 3
    position_iterations: int = 2
    randomize_ball: bool = True
    narrowphase: str = "sat"  # the batched path runs "sat" only
    broadphase: bool = True
    contact: object = None  # Optional[ContactSolverConfig]; None = default
    # run the whole physics step as the fused CUDA kernel (cc, cb and
    # area_cb lanes, and their reverse pass under autograd)
    use_cuda_fused: bool = False


class RoboCupState(NamedTuple):
    bodies: BodyState  # [B, n_bodies, ...]
    t: torch.Tensor  # [B] int32
    key: torch.Tensor  # [B, 2] int64 holding uint32 key words


class RoboCup(PlaneEnvMixin, Environment):
    """Batched RoboCup on ``device`` (the GPU unless the caller asks for the
    CPU); see the module docstring.  Reward is from the blue team's side."""

    def __init__(self, config: RoboCupConfig = RoboCupConfig(), device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        N = config.n_robots_per_team

        field = BodyDef(
            shapes=[box(-np.array(FIELD_DIM) / 2, np.array(FIELD_DIM) / 2)],
            mass=np.inf, inertia=np.inf, is_area=True, name="field",
        )
        play_area = BodyDef(
            shapes=[box(-np.array(PLAY_AREA) / 2, np.array(PLAY_AREA) / 2)],
            mass=np.inf, inertia=np.inf, is_area=True, name="play_area",
        )
        yellow_goal = BodyDef(shapes=_goal_boxes(-1), mass=np.inf, inertia=np.inf,
                              elasticity=0.5, name="yellow_goal")
        blue_goal = BodyDef(shapes=_goal_boxes(+1), mass=np.inf, inertia=np.inf,
                            elasticity=0.5, name="blue_goal")
        ball = BodyDef(
            shapes=[circle(BALL_RADIUS)], mass=0.5, inertia=1.0,
            velocity=(1.0, 0.01), angular_velocity=10.0, elasticity=1.0,
            friction=0.2, name="ball",
        )
        robots = []
        for team, sign in (("blue", +1), ("yellow", -1)):
            for i in range(N):
                robots.append(BodyDef(
                    shapes=[circle(config.robot_radius)],
                    mass=config.robot_mass,
                    inertia=config.robot_inertia,
                    position=(sign * (1.0 + i * 0.8), (i - (N - 1) / 2) * 1.5),
                    elasticity=0.3,
                    friction=0.5,
                    name=f"{team}_{i}",
                ))

        bodies = [field, play_area, yellow_goal, blue_goal, ball] + robots
        self.ball_idx = 4
        self.robot_idx = np.arange(5, 5 + 2 * N)  # the last rows
        # the play area collides with nothing
        filt = [(1, j) for j in range(len(bodies)) if j != 1]
        wc = WorldConfig(
            dt=config.dt,
            gravity=(0.0, 0.0),
            integrator="reference",
            narrowphase=config.narrowphase,
            broadphase=config.broadphase,
            **({} if config.contact is None else {"contact": config.contact}),
            solver_mode=config.solver_mode,
            solver_iterations=config.solver_iterations,
            position_iterations=config.position_iterations,
            use_cuda_solver=True,
            use_cuda_fused=config.use_cuda_fused,
        )
        check_batched_support(wc, "RoboCup")
        self.world, self._init_bodies = World.build(
            bodies, wc, collision_filter=filt, device=self.device
        )
        self._init_planes = init_planes_of(self._init_bodies)

    # -- spaces ---------------------------------------------------------

    @property
    def n_robots(self) -> int:
        return 2 * self.config.n_robots_per_team

    @property
    def action_size(self) -> int:
        return self.n_robots * 3

    @property
    def observation_size(self) -> int:
        return 4 + self.n_robots * 4

    # -- states -----------------------------------------------------------

    def _ball_velocity(self, bkeys):
        """The ball's reset velocity ``([B], [B])`` from ``bkeys``: a unit
        vector at an angle drawn uniform in [0, 2 pi), or the init velocity."""
        if self.config.randomize_ball:
            ang = prng.uniform(bkeys, (), 0.0, 2 * math.pi)
            return torch.cos(ang), torch.sin(ang)
        v = self._init_bodies.vel[self.ball_idx]
        B = bkeys.shape[0]
        return v[0].expand(B), v[1].expand(B)

    def reset_fn_batch(self, keys) -> RoboCupState:
        """``keys`` ``[B, 2]`` -> the kick-off, the ball's direction drawn;
        the key tree of ``reset_fn``: ``split(key) -> (ball, state)``."""
        B = keys.shape[0]
        split = prng.split(keys)  # [B, 2, 2]
        bvx, bvy = self._ball_velocity(split[:, 0])
        b = BodyState(*(x.expand((B,) + x.shape).contiguous() for x in self._init_bodies))
        bi = self.ball_idx
        vel = torch.cat([b.vel[:, :bi], torch.stack([bvx, bvy], -1)[:, None],
                         b.vel[:, bi + 1:]], dim=1)
        return RoboCupState(
            bodies=b._replace(vel=vel),
            t=torch.zeros(B, dtype=torch.int32, device=keys.device),
            key=split[:, 1].contiguous(),
        )

    def observe(self, states: RoboCupState):
        """``[B, 4 + 4R]``: the ball's position and velocity, then every
        robot's position, then every robot's velocity."""
        b = states.bodies
        B, ri = b.pos.shape[0], self.robot_idx
        return torch.cat([b.pos[:, self.ball_idx], b.vel[:, self.ball_idx],
                          b.pos[:, ri].reshape(B, -1), b.vel[:, ri].reshape(B, -1)], dim=-1)

    # -- plane hooks ----------------------------------------------------------

    def plane_make_state(self, bodies, aux, t, key) -> RoboCupState:
        return RoboCupState(bodies=bodies, t=t, key=key)

    def plane_pre(self, s: _SoA, aux, actions) -> _SoA:
        """Each robot's velocity moves toward its command by at most
        ``robot_max_accel * dt``; its angular velocity is set."""
        cfg = self.config
        r0 = int(self.robot_idx[0])
        a = actions.to(torch.float32).reshape(-1, self.n_robots, 3)
        vx_cmd = _clip_c(a[..., 0], -cfg.robot_max_speed, cfg.robot_max_speed).T
        vy_cmd = _clip_c(a[..., 1], -cfg.robot_max_speed, cfg.robot_max_speed).T
        w_cmd = _clip_c(a[..., 2], -cfg.robot_max_omega, cfg.robot_max_omega).T
        lim = cfg.robot_max_accel * cfg.dt
        dvx = _clip_c(vx_cmd - s.vx[r0:], -lim, lim)
        dvy = _clip_c(vy_cmd - s.vy[r0:], -lim, lim)
        return s._replace(
            vx=torch.cat([s.vx[:r0], s.vx[r0:] + dvx]),
            vy=torch.cat([s.vy[:r0], s.vy[r0:] + dvy]),
            omega=torch.cat([s.omega[:r0], w_cmd]),
        )

    def plane_post(self, s: _SoA, aux, con, actions, t_new):
        cfg = self.config
        bi = self.ball_idx

        def damp(x):
            return torch.cat([x[:bi], x[bi:bi + 1] * cfg.ball_damping, x[bi + 1:]])

        s = s._replace(vx=damp(s.vx), vy=damp(s.vy))
        bx, by = s.px[bi], s.py[bi]
        line = PLAY_AREA[0] / 2
        in_mouth = torch.abs(by) < GOAL_DIM[1] / 2
        blue_scored = (bx < -(line + BALL_RADIUS)) & in_mouth  # into the yellow goal
        yellow_scored = (bx > (line + BALL_RADIUS)) & in_mouth
        reward = (
            torch.where(blue_scored, cfg.goal_reward, 0.0)
            - torch.where(yellow_scored, cfg.goal_reward, 0.0)
            + (-cfg.shaping_coef * bx) * cfg.dt
        )
        terminated = blue_scored | yellow_scored
        info = {
            "blue_scored": blue_scored,
            "yellow_scored": yellow_scored,
            "ball_speed": torch.sqrt(s.vx[bi] ** 2 + s.vy[bi] ** 2),
        }
        return s, aux, reward, terminated, info

    def plane_obs(self, s: _SoA, aux):
        bi, r0 = self.ball_idx, int(self.robot_idx[0])
        R, B = self.n_robots, s.px.shape[-1]
        # interleaved [r0x, r0y, r1x, r1y, ...], as bodies.pos[:, ri].reshape(B, -1)
        pos = torch.stack([s.px[r0:], s.py[r0:]], dim=1).reshape(2 * R, B).T
        vel = torch.stack([s.vx[r0:], s.vy[r0:]], dim=1).reshape(2 * R, B).T
        ball = torch.stack([s.px[bi], s.py[bi], s.vx[bi], s.vy[bi]], dim=-1)
        return torch.cat([ball, pos, vel], dim=-1)

    def plane_fresh(self, rkeys):
        """The kick-off planes; ``reset_fn``'s key tree: ``split(key) ->
        (ball, state)``."""
        bi, B = self.ball_idx, rkeys.shape[0]
        bvx, bvy = self._ball_velocity(prng.split(rkeys)[:, 0])
        init = self._init_planes

        def ball_row(x, v):
            return torch.cat([x[:bi].expand(-1, B), v[None], x[bi + 1:].expand(-1, B)])

        return init._replace(vx=ball_row(init.vx, bvx), vy=ball_row(init.vy, bvy)), ()
