"""Billiards: a zero-gravity pool table on the generic plane-space loop (torch).

The port of ``parallax_tpu/envs/billiards.py``'s batched path: a 2 x 1
table with 4 static cushion walls, one cue ball and ``n_object`` object
balls, all circles, so the world's pair groups are ball-ball (``cc``) and
ball-cushion (``cb``).  Rolling friction is a per-step velocity damping in
the post hook.  A ball whose centre comes within ``POCKET_R`` of a corner
is potted: it is parked on a row far above the table with zero velocity
(bodies are never removed).  Action ``[2]``: a bounded acceleration of the
cue ball; reward +1 per newly potted object ball, -1 for potting the cue
(which terminates), +2 when the table is cleared, and a small living cost.

The contact solve runs as the CUDA kernel on a GPU
(``WorldConfig.use_cuda_solver``).  ``BilliardsConfig(use_cuda_fused=True)``
runs the whole step as the fused kernel (``ops/fused_step.py``, the twin of
``use_pallas_fused``) instead, and trains through its reverse pass: it
runs any ``n_object`` (billiards48, 52 parts and C=1320 lanes, keeps the
forward's lane fields in scratch, ``contact_solver.fields_plan``).

The per-world ``reset_fn``/``step_fn`` (states with any leading batch
axes, ``envs/base.py``) step through ``World.step``.  Not ported:
``BilliardsConfig.rolled`` (``engine/rolled.py``, which the port does not
take over).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from parallax_tpu_torch.dynamics.bodies import BodyState
from parallax_tpu_torch.engine.batched import _clip_c, _SoA
from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
from parallax_tpu_torch.envs.base import BatchedEnvironmentMixin, Environment, TimeStep
from parallax_tpu_torch.envs.plane_env import PlaneEnvMixin
from parallax_tpu_torch.geometry.shapes import box, circle
from parallax_tpu_torch.utils import prng
from parallax_tpu_torch.utils.device import resolve as resolve_device

# table half-extents and ball size (pool-table 2:1 aspect)
HALF_W, HALF_H = 1.0, 0.5
BALL_R = 0.04
WALL_T = 0.1
POCKET_R = 0.09
PARK_Y = 10.0  # parking row for potted balls, far outside interaction range
# the float32 value JAX compares against (POCKET_R**2 as a weak-typed scalar)
_POCKET_R2 = float(np.float32(POCKET_R**2))

_CORNERS = np.asarray(
    [[-HALF_W, -HALF_H], [HALF_W, -HALF_H], [-HALF_W, HALF_H], [HALF_W, HALF_H]],
    np.float32,
)


@dataclasses.dataclass(frozen=True)
class BilliardsConfig:
    n_object: int = 7
    dt: float = 0.01
    damping: float = 0.99  # per-step rolling-friction velocity decay
    accel: float = 3.0  # max cue acceleration per axis
    elasticity: float = 0.92
    wall_elasticity: float = 0.85
    friction: float = 0.1
    max_steps: int = 1000
    pot_reward: float = 1.0
    clear_bonus: float = 2.0
    cue_penalty: float = 1.0
    living_cost: float = 0.001
    solver_iterations: int = 4
    position_iterations: int = 2
    # run the whole physics step as the fused CUDA kernel (cc/cb lanes, and
    # their reverse pass under autograd), for any n_object
    use_cuda_fused: bool = False
    # the JAX package's offset-rolled all-pairs physics (engine/rolled.py):
    # not ported, so True raises
    rolled: bool = False


class BilliardsState(NamedTuple):
    bodies: BodyState  # [B, n_bodies, ...]
    potted: torch.Tensor  # [B, 1 + n_object] bool (index 0 = cue)
    t: torch.Tensor  # [B] int32
    key: torch.Tensor  # [B, 2] int64 holding uint32 key words


def _rack_positions(n_object: int) -> np.ndarray:
    """Cue on the left, object balls racked in a triangle on the right.

    The rack fits itself to the table: rows are capped at the count that
    fits the table height (the triangle becomes a trapezoid for large n),
    and the apex slides left so the back row clears the right cushion.
    Small racks (n <= 15) keep the apex at x = 0.45.
    """
    # 2.2r spacing leaves 0.008 of clearance over the 0.08 contact distance,
    # more than the +/-0.002 reset jitter can close
    gap = 2.2 * BALL_R
    margin = 0.01
    # the row height budget reserves gap/2 for the stagger below
    max_per_row = int((2.0 * (HALF_H - BALL_R - margin) - gap) // gap) + 1
    counts = []
    placed = 0
    while placed < n_object:
        c = min(len(counts) + 1, max_per_row, n_object - placed)
        counts.append(c)
        placed += c
    x_apex = min(0.45, HALF_W - BALL_R - margin - (len(counts) - 1) * gap * 0.87)
    if x_apex <= BALL_R - 0.5:  # the rack would reach the cue's half
        raise ValueError(
            f"{n_object} object balls cannot be racked on the "
            f"{2 * HALF_W}x{2 * HALF_H} table"
        )
    pos = [(-0.5, 0.0)]
    for row, c in enumerate(counts):
        x = x_apex + row * gap * 0.87
        # adjacent rows' y-grids sit gap/2 apart: a row's natural offset is
        # 0 for odd counts and gap/2 for even; shift to alternate 0, gap/2
        natural = 0.0 if c % 2 else 0.5
        shift = (((row % 2) * 0.5 - natural) % 1.0) * gap
        for i in range(c):
            pos.append((x, (i - (c - 1) / 2.0) * gap + shift))
    return np.asarray(pos, np.float32)


class Billiards(PlaneEnvMixin, BatchedEnvironmentMixin, Environment):
    """Batched billiards on ``device`` (the GPU unless the caller asks for
    the CPU); see the module docstring."""

    def __init__(self, config: BilliardsConfig = BilliardsConfig(), device="cuda"):
        if config.rolled:
            raise NotImplementedError(
                "BilliardsConfig(rolled=True) runs the JAX package's "
                "engine/rolled.py, which the port does not take over (ROADMAP "
                "'Do not port'); use the default rolled=False"
            )
        self.config = config
        self.device = resolve_device(device)
        n = 1 + config.n_object
        rack = _rack_positions(config.n_object)

        balls = [
            BodyDef(
                shapes=[circle(BALL_R)],
                mass=1.0,
                inertia=2.0 / 5.0 * BALL_R**2,
                position=tuple(rack[i]),
                elasticity=config.elasticity,
                friction=config.friction,
                name="cue" if i == 0 else f"ball{i}",
            )
            for i in range(n)
        ]
        w, h, t = HALF_W, HALF_H, WALL_T
        walls = [
            BodyDef(shapes=[box(lo, hi)], mass=np.inf, inertia=np.inf,
                    elasticity=config.wall_elasticity, friction=config.friction,
                    name=nm)
            for nm, (lo, hi) in (
                ("wall_b", ((-w - t, -h - t), (w + t, -h))),
                ("wall_t", ((-w - t, h), (w + t, h + t))),
                ("wall_l", ((-w - t, -h), (-w, h))),
                ("wall_r", ((w, -h), (w + t, h))),
            )
        ]
        wc = WorldConfig(
            dt=config.dt,
            gravity=(0.0, 0.0),
            integrator="symplectic",
            solver_iterations=config.solver_iterations,
            position_iterations=config.position_iterations,
            use_cuda_solver=True,
            use_cuda_fused=config.use_cuda_fused,
        )
        self.world, self._init_bodies = World.build(balls + walls, wc, device=self.device)
        self.n_balls = n
        ib = self._init_bodies
        # [n_bodies, 1] init planes for the plane-space auto-reset
        self._init_px = ib.pos[:, 0:1].clone()
        self._init_py = ib.pos[:, 1:2].clone()
        self._init_angle = ib.angle[:, None].clone()
        # per-ball parking slots: a row above the table, spaced > 2r apart
        self._park_x = torch.from_numpy(
            np.linspace(-n, n, n, dtype=np.float32)[:, None]).to(self.device)
        self._park_y = torch.full((n, 1), PARK_Y, dtype=torch.float32, device=self.device)
        self._park = torch.cat([self._park_x, self._park_y], dim=-1)  # [n, 2]
        self._corners = torch.from_numpy(_CORNERS).to(self.device)
        self._corner_x = torch.from_numpy(_CORNERS[:, 0][None, :, None].copy()).to(self.device)
        self._corner_y = torch.from_numpy(_CORNERS[:, 1][None, :, None].copy()).to(self.device)

    # -- spaces ---------------------------------------------------------

    @property
    def action_size(self) -> int:
        return 2

    @property
    def observation_size(self) -> int:
        return self.n_balls * 5  # per ball: pos (2), vel (2), potted (1)

    # -- states -----------------------------------------------------------

    def _jitter(self, keys):
        """The reset jitter of each ball, ``[..., n, 2]``, from ``keys``."""
        return prng.uniform(keys, (self.n_balls, 2), -0.002, 0.002)

    def reset_fn(self, key) -> BilliardsState:
        """``key`` ``[..., 2]`` -> fresh racks, each ball jittered; the key
        tree ``split(key) -> (jitter, state)`` (``reset_fn_batch`` is this
        on ``[B, 2]`` keys)."""
        n, shape = self.n_balls, key.shape[:-1]
        split = prng.split(key)  # [..., 2, 2]
        jitter = self._jitter(split[..., 0, :])
        b = BodyState(*(x.expand(shape + x.shape).contiguous() for x in self._init_bodies))
        pos = torch.cat([b.pos[..., :n, :] + jitter, b.pos[..., n:, :]], dim=-2)
        return BilliardsState(
            bodies=b._replace(pos=pos),
            potted=torch.zeros(shape + (n,), dtype=torch.bool, device=key.device),
            t=torch.zeros(shape, dtype=torch.int32, device=key.device),
            key=split[..., 1, :].contiguous(),
        )

    def observe(self, states: BilliardsState):
        """``[..., 5n]``: per ball x, y, vx, vy and its potted flag."""
        n = self.n_balls
        b = states.bodies
        per_ball = torch.cat(
            [b.pos[..., :n, :], b.vel[..., :n, :], states.potted[..., None].to(b.pos.dtype)],
            dim=-1,
        )
        return per_ball.reshape(per_ball.shape[:-2] + (-1,))

    def _pot_hits(self, pos_balls):
        """``[..., n]`` bool: the ball's centre within ``POCKET_R`` of a corner."""
        d2 = torch.sum((pos_balls[..., :, None, :] - self._corners) ** 2, dim=-1)
        return torch.any(d2 <= _POCKET_R2, dim=-1)

    def step_fn(self, state: BilliardsState, action):
        cfg = self.config
        n = self.n_balls
        a = torch.as_tensor(action, dtype=torch.float32, device=state.t.device)
        a = _clip_c(a.reshape(state.t.shape + (2,)), -1.0, 1.0)
        b = state.bodies

        # cue acceleration, only while the cue is live
        live_cue = ~state.potted[..., 0]
        vel = b.vel.clone()
        vel[..., 0, :] = vel[..., 0, :] + a * cfg.accel * cfg.dt * live_cue[..., None]
        b, _ = self.world.step(b._replace(vel=vel))
        # rolling friction; potted balls stay frozen in their slots
        damp = torch.where(state.potted[..., None], 0.0, cfg.damping)  # [..., n, 1]
        vel = torch.cat([b.vel[..., :n, :] * damp, b.vel[..., n:, :]], dim=-2)

        new_pot = self._pot_hits(b.pos[..., :n, :]) & ~state.potted
        potted = state.potted | new_pot
        # teleport newly potted balls to their parking slots
        pos_balls = torch.where(new_pot[..., None], self._park, b.pos[..., :n, :])
        vel_balls = torch.where(new_pot[..., None], 0.0, vel[..., :n, :])
        b = b._replace(
            pos=torch.cat([pos_balls, b.pos[..., n:, :]], dim=-2),
            vel=torch.cat([vel_balls, vel[..., n:, :]], dim=-2),
        )

        cue_lost = potted[..., 0]
        cleared = potted[..., 1:].all(dim=-1)
        reward = (
            cfg.pot_reward * new_pot[..., 1:].sum(dim=-1)
            - cfg.cue_penalty * new_pot[..., 0]
            + torch.where(cleared & new_pot[..., 1:].any(dim=-1), cfg.clear_bonus, 0.0)
            - cfg.living_cost
        )
        new_state = state._replace(bodies=b, potted=potted, t=state.t + 1)
        terminated = cue_lost | cleared
        truncated = (new_state.t >= cfg.max_steps) & ~terminated
        ts = TimeStep(
            obs=self.observe(new_state),
            reward=reward,
            terminated=terminated,
            truncated=truncated,
            info={"potted": potted, "cue_lost": cue_lost, "cleared": cleared},
        )
        return new_state, ts

    # -- plane hooks; aux = potted [n_balls, B] float 0/1 planes ------------

    def plane_pack(self, states: BilliardsState):
        return states.potted.T.to(torch.float32).contiguous()

    def plane_make_state(self, bodies, aux, t, key) -> BilliardsState:
        return BilliardsState(bodies=bodies, potted=aux.T > 0.5, t=t, key=key)

    def plane_pre(self, s: _SoA, potted, actions) -> _SoA:
        cfg = self.config
        a = _clip_c(actions.to(torch.float32).reshape(-1, 2), -1.0, 1.0)
        live_cue = 1.0 - potted[0]  # the cue is kicked only while it is live

        def add_row0(x, d):
            return torch.cat([(x[0] + d)[None], x[1:]])

        return s._replace(
            vx=add_row0(s.vx, a[:, 0] * cfg.accel * cfg.dt * live_cue),
            vy=add_row0(s.vy, a[:, 1] * cfg.accel * cfg.dt * live_cue),
        )

    def plane_post(self, s: _SoA, potted, con, actions, t_new):
        cfg = self.config
        n = self.n_balls

        def balls(x, new):  # rows [:n] of a body plane replaced by ``new``
            return torch.cat([new, x[n:]])

        damp = torch.where(potted > 0.5, 0.0, cfg.damping)  # [n, B]
        vx = s.vx[:n] * damp
        vy = s.vy[:n] * damp

        # pot detection on [n, B] planes
        dx = s.px[:n, None, :] - self._corner_x
        dy = s.py[:n, None, :] - self._corner_y
        d2 = dx * dx + dy * dy  # [n, 4, B]
        hit = d2.amin(dim=1) <= _POCKET_R2
        new_pot = hit & (potted < 0.5)
        potted = torch.where(new_pot, 1.0, potted)
        s = s._replace(
            px=balls(s.px, torch.where(new_pot, self._park_x, s.px[:n])),
            py=balls(s.py, torch.where(new_pot, self._park_y, s.py[:n])),
            vx=balls(s.vx, torch.where(new_pot, 0.0, vx)),
            vy=balls(s.vy, torch.where(new_pot, 0.0, vy)),
        )

        cue_lost = potted[0] > 0.5
        cleared = (potted[1:] > 0.5).all(dim=0)
        reward = (
            cfg.pot_reward * new_pot[1:].sum(dim=0)
            - cfg.cue_penalty * new_pot[0]
            + torch.where(cleared & new_pot[1:].any(dim=0), cfg.clear_bonus, 0.0)
            - cfg.living_cost
        )
        terminated = cue_lost | cleared
        # no per-ball "potted" in info: it is in obs and in the carried state
        info = {"cue_lost": cue_lost, "cleared": cleared}
        return s, potted, reward, terminated, info

    def plane_obs(self, s: _SoA, potted):
        rows = []
        for i in range(self.n_balls):
            rows.extend([s.px[i], s.py[i], s.vx[i], s.vy[i], potted[i]])
        return torch.stack(rows, dim=-1)  # [B, 5n]

    def plane_fresh(self, rkeys):
        """A fresh rack with jitter; ``reset_fn``'s key tree:
        ``split(key) -> (jitter, state)``."""
        n = self.n_balls
        jit = self._jitter(prng.split(rkeys)[:, 0])  # [B, n, 2]
        px = torch.cat([self._init_px[:n] + jit[..., 0].T,
                        self._init_px[n:].expand(-1, rkeys.shape[0])])
        py = torch.cat([self._init_py[:n] + jit[..., 1].T,
                        self._init_py[n:].expand(-1, rkeys.shape[0])])
        fresh = _SoA(px=px, py=py, vx=0.0, vy=0.0, angle=self._init_angle, omega=0.0)
        return fresh, 0.0
