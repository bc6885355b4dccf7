"""LunarLander: 4-body jointed lander over per-world random terrain (torch).

The port of ``parallax_tpu/envs/lunar_lander.py``'s batched plane-space
path: the same bodies, masses, joints, thrust, reward and termination,
and the same terrain for the same PRNG key (``utils/prng.py`` reproduces
jax's threefry bits).

Bodies: 0 lander (6-gon), 1 right leg, 2 left leg (quads), 3 ground (7
quad terrain segments whose vertices live in the state, one terrain per
world).  The world runs the contact solve as the CUDA kernel when its
tensors are on a GPU (``WorldConfig.use_cuda_solver``), or, with
``LanderConfig(use_cuda_fused=True, broadphase=False)``, the whole step
as the fused kernel (``ops/fused_step.py``, the twin of
``use_pallas_fused``), whose reverse-pass kernel carries training.

The per-world ``reset_fn``/``step_fn`` (states with any leading batch
axes, ``envs/base.py``) step through ``World.step`` on a world whose
ground parts hold each world's terrain (``_world_with_terrain``), and so
run the reference-parity knobs (``narrowphase="gjk_epa"``, the random
solver modes); ``LanderJudge`` and ``make_world_forward`` drive the
continuous-time ``evaluate``.

``LanderConfig(terrain_candidates=True)`` pairs each dynamic body, on the
batched path only, with a sliding window of K consecutive terrain
segments (the lander 5, each leg 3) in place of all 7: the candidate
world has 28 contact lanes where the full one has 48, and each step
gathers the windows' vertex planes per world (``_candidate_override``).
The per-world path keeps the full world.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from parallax_tpu_torch.dynamics.bodies import BodyState
from parallax_tpu_torch.dynamics.joints import Joints
from parallax_tpu_torch.engine.batched import _clip_c, _SoA, physics_core
from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
from parallax_tpu_torch.envs.base import BatchedEnvironmentMixin, Environment, Judge, TimeStep
from parallax_tpu_torch.envs.plane_env import PlaneEnvMixin, init_planes_of
from parallax_tpu_torch.geometry.math import _abs_j, rotate, safe_norm
from parallax_tpu_torch.geometry.shapes import MAX_VERTS, polygon
from parallax_tpu_torch.ops import threefry
from parallax_tpu_torch.utils import prng
from parallax_tpu_torch.utils.device import resolve as resolve_device

# ---- reference constants ---------------------------------------------------

LANDER_POLY = np.array(
    [(-14, 17), (-17, 0), (-17, -10), (17, -10), (17, 0), (14, 17)], np.float32
)
LEG_AWAY = 24
LEG_DOWN = 8
LEG_W, LEG_H = 2, 8
LEG_ANGLE = -0.3
SCALE = 0.05

N_TERRAIN = 7
PAD_X = (-2.0, 2.0)
PAD_Y = -2.0


def _leg_vertices(side: int) -> np.ndarray:
    """Leg quad rotated by -LEG_ANGLE (``v @ R``) and scaled; side=+1 left
    leg, -1 right leg."""
    v = np.array(
        [(-LEG_W, -LEG_H), (LEG_W, -LEG_H), (LEG_W, LEG_H), (-LEG_W, LEG_H)],
        np.float32,
    )
    a = LEG_ANGLE
    R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]], np.float32)
    v = v @ R
    v = v * SCALE
    if side < 0:
        v = v * np.array([-1.0, 1.0], np.float32)
    return v


@dataclasses.dataclass(frozen=True)
class LanderConfig:
    dt: float = 0.01
    gravity: float = 0.2
    main_power: float = 0.5  # peak main-engine acceleration [u/s^2]
    side_power: float = 0.1  # lateral acceleration at full side throttle
    side_torque: float = 0.6  # angular acceleration at full side throttle
    fuel_cost_main: float = 0.03
    fuel_cost_side: float = 0.003
    max_steps: int = 1000
    solver_mode: str = "block"
    narrowphase: str = "sat"
    broadphase: bool = True
    contact: object = None  # Optional[ContactSolverConfig]; None = default
    # run the whole physics step as one CUDA kernel (ops/fused_step.py);
    # requires broadphase=False (the kernel has no AABB pre-mask stage)
    use_cuda_fused: bool = False
    # batched path only: pair each dynamic body with a per-world window of K
    # consecutive terrain segments instead of all 7 (K from the body's
    # circumradius against the sampler's least inner segment width); the
    # same physics on 28 contact lanes instead of 48
    terrain_candidates: bool = False
    # lander contact graphs are shallow (legs + lander vs ground)
    solver_iterations: int = 3
    position_iterations: int = 2
    leg_omega_damping: float = 0.95
    landed_speed: float = 0.08
    landed_omega: float = 0.2
    crash_tilt: float = 1.4
    out_x: float = 15.0
    out_y: float = -9.5
    landed_bonus: float = 10.0
    crash_penalty: float = -10.0


class LanderState(NamedTuple):
    bodies: BodyState  # [B, n, ...]
    # ground segment vertices (world frame), flat [B, 7 * MAX_VERTS * 2]
    terrain: torch.Tensor
    t: torch.Tensor  # [B] int32 step counter
    key: torch.Tensor  # [B, 2] int64 holding uint32 key words
    prev_shaping: torch.Tensor  # [B] f32 potential-based reward memory
    # [B, 2] f32: previous step's (left, right) leg-ground contact flags
    leg_contacts: torch.Tensor

    @property
    def terrain_view(self):
        """The flat terrain as ``[..., 7, MAX_VERTS, 2]`` vertices."""
        return self.terrain.reshape(self.terrain.shape[:-1] + (N_TERRAIN, MAX_VERTS, 2))


class LanderAux(NamedTuple):
    """Env-specific plane aux for the generic plane loop."""

    tox: torch.Tensor  # [7, V, B] terrain x
    toy: torch.Tensor  # [7, V, B] terrain y
    prev_shaping: torch.Tensor  # [B]
    lc: torch.Tensor  # [2, B] previous-step leg contact flags (f32)


def _pseudo_angle(dx, dy):
    """Diamond pseudo-angle: strictly monotone in ``atan2(dy, dx)``; the
    terrain sampler's clockwise-ordering key."""
    p = dy / (torch.abs(dx) + torch.abs(dy))
    return torch.where(dx >= 0.0, p, torch.where(dy >= 0.0, 2.0 - p, -2.0 - p))


def terrain_planes_batch(keys, split_first=False):
    """Batch-minor terrain sampler: ``keys`` ``[B, 2]`` -> ``(qx, qy)``
    ``[7, V, B]`` world-frame planes, bit-identical to the JAX package's
    for the same keys (same key splits and draws; the clockwise order as a
    stable 4-element sorting network on the same pseudo-angle key).
    ``split_first`` draws each world's terrain from ``split(key)[0]``, as
    the auto-reset does.  On CUDA keys the whole draw is one kernel
    (``ops/threefry.py:lander_terrain``), on CPU keys its plain version,
    :func:`terrain_planes_plain`."""
    if keys.is_cuda:
        return threefry.lander_terrain(keys, split_first, MAX_VERTS)
    return terrain_planes_plain(keys, split_first)


def terrain_planes_plain(keys, split_first=False):
    """:func:`terrain_planes_batch`'s torch body, on any device."""
    if split_first:
        keys = prng.split_plain(keys)[:, 0]
    B = keys.shape[0]
    ks = prng.split_plain(keys, 5)  # [B, 5, 2]
    heights = prng.uniform_plain(ks[:, 0], (8,), -5.0, 5.0).T.contiguous()  # [8, B]
    heights[0] = heights[0] * 10.0
    heights[3] = -2.0
    heights[4] = -2.0
    heights[7] = heights[7] * 10.0

    def u(i, lo, hi):
        return prng.uniform_plain(ks[:, i], (), lo, hi)

    ones = torch.ones(B, dtype=torch.float32, device=keys.device)
    positions = torch.stack(
        [
            -100.0 * ones,
            u(1, -12.0, -9.0),
            u(2, -8.0, -4.0),
            -2.0 * ones,
            2.0 * ones,
            u(3, 4.0, 8.0),
            u(4, 9.0, 12.0),
            100.0 * ones,
        ]
    )  # [8, B]
    x0, x1 = positions[:-1], positions[1:]  # [7, B]
    h0, h1 = heights[:-1], heights[1:]
    bottom = torch.full_like(x0, -10.0)
    qx = torch.stack([x0, x0, x1, x1], dim=1)  # [7, 4, B]
    qy = torch.stack([h0, bottom, h1, bottom], dim=1)

    cx = qx.sum(1, keepdim=True) / 4.0
    cy = qy.sum(1, keepdim=True) / 4.0
    ang = _pseudo_angle(qx - cx, qy - cy)
    idx = torch.arange(4.0, device=keys.device)[None, :, None].expand(ang.shape)

    rows = [list(t.unbind(1)) for t in (ang, idx, qx, qy)]
    for i, j in ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2)):
        ai, aj = rows[0][i], rows[0][j]
        swap = (ai > aj) | ((ai == aj) & (rows[1][i] > rows[1][j]))
        for r in rows:
            r[i], r[j] = torch.where(swap, r[j], r[i]), torch.where(swap, r[i], r[j])

    pad = [0, 1, 2, 3] + [3] * (MAX_VERTS - 4)
    qx = torch.stack([rows[2][k] for k in pad], dim=1)
    qy = torch.stack([rows[3][k] for k in pad], dim=1)
    return qx, qy  # [7, V, B]


def terrain_vertices_batch(keys):
    """``keys`` ``[B, 2]`` -> flat ``[B, 7*MAX_VERTS*2]`` terrain."""
    qx, qy = terrain_planes_batch(keys)
    terrain = torch.stack([qx, qy], dim=2)  # [7, V, 2, B]
    return terrain.permute(3, 0, 1, 2).reshape(keys.shape[0], -1)


def terrain_vertices(key):
    """One world's terrain: ``key`` ``[2]`` -> ``[7, MAX_VERTS, 2]``
    clockwise-ordered, repeat-padded world-frame quads (the JAX package's
    per-world sampler), bit-equal to its row of
    :func:`terrain_vertices_batch`."""
    return terrain_vertices_batch(key[None])[0].reshape(N_TERRAIN, MAX_VERTS, 2)


class LunarLander(PlaneEnvMixin, BatchedEnvironmentMixin, Environment):
    """Batched LunarLander on ``device`` (the GPU unless the caller asks for
    the CPU); see the module docstring."""

    def __init__(self, config: LanderConfig = LanderConfig(), device="cuda"):
        self.config = config
        if config.use_cuda_fused and config.broadphase:
            # a silent fallback to the split path would make users believe
            # they are measuring the fused kernel
            raise ValueError(
                "use_cuda_fused requires broadphase=False (the fused "
                "kernel has no AABB pre-mask stage): "
                "LanderConfig(use_cuda_fused=True, broadphase=False)"
            )
        self.device = resolve_device(device)

        lander = BodyDef(
            shapes=[polygon(LANDER_POLY * SCALE)],
            mass=30.0,
            inertia=30.0,
            position=(0.0, 5.0),
            angle=0.01,
            friction=0.1,
            name="lander",
        )
        right_leg = BodyDef(
            shapes=[polygon(_leg_vertices(-1))],
            mass=1.0,
            inertia=1.0,
            position=(-LEG_AWAY * SCALE, -LEG_DOWN * SCALE + 5.0),
            friction=0.1,
            name="right_leg",
        )
        left_leg = BodyDef(
            shapes=[polygon(_leg_vertices(+1))],
            mass=1.0,
            inertia=1.0,
            position=(LEG_AWAY * SCALE, -LEG_DOWN * SCALE + 5.0),
            friction=0.1,
            name="left_leg",
        )
        # terrain placeholder quads; real vertices come from the state
        ground = BodyDef(
            shapes=[
                polygon([(i, -9.0), (i + 1.0, -9.0), (i + 1.0, -10.0), (i, -10.0)])
                for i in range(N_TERRAIN)
            ],
            mass=np.inf,
            inertia=np.inf,
            elasticity=0.1,
            friction=0.1,
            name="ground",
        )

        # two joints per leg; order matters for the sequential solve:
        # left1, left2, right1, right2
        joints = Joints.make(
            body_a=[0, 0, 0, 0],
            body_b=[2, 2, 1, 1],
            anchor_a=np.array(
                [
                    [LEG_AWAY * SCALE, -LEG_DOWN * SCALE],
                    [LEG_AWAY * SCALE, (-LEG_DOWN + 8) * SCALE],
                    [-LEG_AWAY * SCALE, -LEG_DOWN * SCALE],
                    [-LEG_AWAY * SCALE, (-LEG_DOWN + 8) * SCALE],
                ],
                np.float32,
            ),
            anchor_b=np.array(
                [[0.0, 0.0], [0.0, 0.4], [0.0, 0.0], [0.0, 0.4]], np.float32
            ),
            kp=1.0,
            kd=0.05,
            v0=0.1,
        )

        wc = WorldConfig(
            dt=config.dt,
            gravity=(0.0, -config.gravity),
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
        self.world, self._init_bodies = World.build(
            [lander, right_leg, left_leg, ground], wc, joints=joints,
            device=self.device,
        )

        # -- the batched path's world: per-body terrain-candidate windows --
        # A dynamic body of circumradius R centred inside segment i can only
        # overlap segments i-m..i+m with m = floor(R / MIN_SEG_W) + 1.
        # MIN_SEG_W = 1.0 is the least inner segment width of the terrain
        # sampler (its adjacent position draws lie >= 1.0 apart; the two
        # edge segments run to +-100).  The candidate world gives each
        # dynamic body its own K = 2m+1 ground parts, whose vertex planes
        # are gathered per world and step: every contact that can be active
        # lies inside the window, so the physics is the full table's.
        self._use_candidates = bool(config.terrain_candidates)
        if self._use_candidates:
            MIN_SEG_W = 1.0
            pv = self.world.parts.verts.cpu().numpy()
            ms, Ks = [], []
            for part in (0, 1, 2):
                nv = self.world.parts.nverts[part]
                r = float(np.linalg.norm(pv[part, :nv], axis=1).max())
                m = int(np.floor(r / MIN_SEG_W)) + 1
                ms.append(m)
                Ks.append(min(2 * m + 1, N_TERRAIN))
            ground_cand = BodyDef(
                shapes=[
                    polygon([(i, -9.0), (i + 1.0, -9.0), (i + 1.0, -10.0), (i, -10.0)])
                    for i in range(sum(Ks))
                ],
                mass=np.inf,
                inertia=np.inf,
                elasticity=0.1,
                friction=0.1,
                name="ground",
            )
            starts = [3 + int(s) for s in np.cumsum([0] + Ks[:-1])]
            part_filter = [
                (b_i, gp)
                for b_i in range(3)
                for gp in range(3, 3 + sum(Ks))
                if not starts[b_i] <= gp < starts[b_i] + Ks[b_i]
            ]
            self._bm_world, _ = World.build(
                [lander, right_leg, left_leg, ground_cand], wc, joints=joints,
                part_collision_filter=part_filter, device=self.device,
            )
            self._cand_parts = [(starts[i], Ks[i], ms[i]) for i in range(3)]
            # a row per candidate part, in order: the dynamic body it serves,
            # its place in the window, the body's m and its window's last start
            self._cand_rows = torch.tensor(
                [(bi, j, m, N_TERRAIN - K)
                 for bi, (_, K, m) in enumerate(self._cand_parts) for j in range(K)],
                device=self.device,
            )
        else:
            self._bm_world = self.world

        # static contact-lane index lists: which lanes touch which bodies.
        # The per-world path reads the full world's lanes, the batched path
        # (plane hooks) the batched world's
        def lanes(world, body):
            ba = np.asarray(world.table.body_a)
            bb = np.asarray(world.table.body_b)
            sel = ((ba == body) & (bb == 3)) | ((ba == 3) & (bb == body))
            return torch.from_numpy(np.nonzero(sel)[0]).to(self.device)

        self._left_leg_lanes = lanes(self.world, 2)
        self._right_leg_lanes = lanes(self.world, 1)
        self._lander_ground_lanes = lanes(self.world, 0)
        self._bm_left_leg_lanes = lanes(self._bm_world, 2)
        self._bm_right_leg_lanes = lanes(self._bm_world, 1)
        self._bm_lander_ground_lanes = lanes(self._bm_world, 0)
        self._ground_parts = [
            i for i, b in enumerate(self.world.parts.body) if b == 3
        ]
        # leg omega damping (bodies 1 and 2), [n] per world, [n, 1] on planes
        self._omega_damp_n = torch.tensor(
            [1.0, config.leg_omega_damping, config.leg_omega_damping, 1.0],
            dtype=torch.float32, device=self.device,
        )
        self._omega_damp = self._omega_damp_n[:, None]

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=self.device)

        self._pad_obs = f32([0.0, PAD_Y])
        self._pad_target = f32([0.0, PAD_Y + 1.0])
        self._up, self._right = f32([0.0, 1.0]), f32([1.0, 0.0])

        # initial-state planes for in-graph resets ([n, 1] broadcast)
        ib = self._init_bodies
        self._init_planes = init_planes_of(ib)
        pos0 = ib.pos.cpu().numpy()
        px0, py0 = float(pos0[0, 0]), float(pos0[0, 1])
        self._init_shaping = (
            -float(np.sqrt(px0 * px0 + (py0 - (PAD_Y + 1.0)) ** 2))
            - 0.0
            - abs(float(ib.angle[0]))
        )

    # ------------------------------------------------------------------

    @property
    def action_size(self) -> int:
        return 2  # [main in [0,1] (negatives = off), side in [-1,1]]

    @property
    def observation_size(self) -> int:
        return 9

    # -- the per-world API (any leading batch axes) ------------------------

    def _world_with_terrain(self, terrain_flat) -> World:
        """The world whose ground parts hold ``terrain_flat`` ``[...,
        7*MAX_VERTS*2]``: its ``parts.verts`` is ``[..., P, V, 2]``, one
        terrain a world (the ground is the last body, its parts the last
        parts, at the origin: local frame = world frame)."""
        terrain = terrain_flat.reshape(terrain_flat.shape[:-1] + (N_TERRAIN, MAX_VERTS, 2))
        g0 = self._ground_parts[0]
        head = self.world.parts.verts[:g0]
        verts = torch.cat([head.expand(terrain.shape[:-3] + head.shape), terrain], dim=-3)
        return dataclasses.replace(self.world, parts=self.world.parts.replace(verts=verts))

    def reset_fn(self, key) -> LanderState:
        """``key`` ``[..., 2]`` -> fresh states, each with its own terrain;
        the key tree ``split(key) -> (terrain, state)``."""
        shape = key.shape[:-1]
        split = prng.split(key)
        tkey, skey = split[..., 0, :], split[..., 1, :]
        terrain = terrain_vertices_batch(tkey.reshape(-1, 2)).reshape(shape + (-1,))
        state = LanderState(
            bodies=BodyState(
                *(x.expand(shape + x.shape).contiguous() for x in self._init_bodies)
            ),
            terrain=terrain,
            t=torch.zeros(shape, dtype=torch.int32, device=key.device),
            key=skey.contiguous(),
            prev_shaping=torch.zeros(shape, dtype=torch.float32, device=key.device),
            leg_contacts=torch.zeros(shape + (2,), dtype=torch.float32, device=key.device),
        )
        no_legs = torch.zeros(shape + (2,), dtype=torch.bool, device=key.device)
        return state._replace(prev_shaping=self._shaping(state, no_legs))

    def observe(self, state: LanderState):
        """``[..., 9]``: the lander's position above the pad, velocity, sin
        and cos of its angle, its angular velocity, the leg contact flags."""
        b = state.bodies
        ang = b.angle[..., 0]
        return torch.cat(
            [
                b.pos[..., 0, :] - self._pad_obs,
                b.vel[..., 0, :],
                torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1),
                b.omega[..., 0, None],
                state.leg_contacts.to(b.pos.dtype),
            ],
            dim=-1,
        )

    def _observe_with_contacts(self, state, leg_contacts):
        obs = self.observe(state)
        return torch.cat([obs[..., :7], leg_contacts.to(obs.dtype)], dim=-1)

    def _shaping(self, state: LanderState, leg_contacts):
        b = state.bodies
        dist = safe_norm(b.pos[..., 0, :] - self._pad_target)
        speed = safe_norm(b.vel[..., 0, :])
        return (
            -1.0 * dist
            - 1.0 * speed
            - 1.0 * _abs_j(b.angle[..., 0])
            + 0.3 * torch.sum(leg_contacts, dim=-1)
        )

    def _thrust(self, bodies, main, side, dt):
        """The engines' velocity kicks on the lander (body 0) over ``dt``."""
        cfg = self.config
        ang = bodies.angle[..., 0]
        dv = rotate(self._up, ang) * (cfg.main_power * main * dt)[..., None] + rotate(
            self._right, ang
        ) * (cfg.side_power * side * dt)[..., None]
        vel, omega = bodies.vel.clone(), bodies.omega.clone()
        vel[..., 0, :] = vel[..., 0, :] + dv
        omega[..., 0] = omega[..., 0] + -cfg.side_torque * side * dt
        return bodies._replace(vel=vel, omega=omega)

    def _leg_flags(self, active):
        """``(left, right, lander)`` ground-contact flags from ``[..., C]``
        active lanes."""
        return (active[..., self._left_leg_lanes].any(-1),
                active[..., self._right_leg_lanes].any(-1),
                active[..., self._lander_ground_lanes].any(-1))

    def step_fn(self, state: LanderState, action):
        cfg = self.config
        action = torch.as_tensor(action, dtype=torch.float32, device=state.t.device)
        action = action.reshape(state.t.shape + (2,))  # [main, side]
        main = _clip_c(action[..., 0], 0.0, 1.0)
        side = _clip_c(action[..., 1], -1.0, 1.0)

        b = self._thrust(state.bodies, main, side, cfg.dt)
        world = self._world_with_terrain(state.terrain)
        # the random reference solvers draw their lane choices from the
        # episode stream (fold_in: no extra key in the state; Environment.step
        # re-splits state.key every step, so this stays fresh)
        solver_key = (
            prng.fold_in(state.key, 0x501E)
            if world.config.solver_mode.startswith("random_one_per_body")
            else None
        )
        b, contacts = world.step(b, key=solver_key)
        b = b._replace(omega=b.omega * self._omega_damp_n)

        left, right, lander_contact = self._leg_flags(contacts.active)
        leg_contacts = torch.stack([left, right], dim=-1)
        new_state = state._replace(
            bodies=b, t=state.t + 1, leg_contacts=leg_contacts.to(torch.float32)
        )

        speed = safe_norm(b.vel[..., 0, :])
        ang, px, py = b.angle[..., 0], b.pos[..., 0, 0], b.pos[..., 0, 1]
        landed = (
            left & right
            & (speed < cfg.landed_speed)
            & (torch.abs(b.omega[..., 0]) < cfg.landed_omega)
            & (torch.abs(ang) < 0.3)
        )
        crashed = (
            lander_contact
            | (torch.abs(px) > cfg.out_x)
            | (py < cfg.out_y)
            | (torch.abs(ang) > cfg.crash_tilt)
        )
        truncated = new_state.t >= cfg.max_steps

        shaping = self._shaping(new_state, leg_contacts)
        reward = (
            shaping
            - state.prev_shaping
            - cfg.fuel_cost_main * main
            - cfg.fuel_cost_side * _abs_j(side)
        )
        reward = reward + torch.where(landed, cfg.landed_bonus, 0.0)
        reward = reward + torch.where(crashed, cfg.crash_penalty, 0.0)
        new_state = new_state._replace(prev_shaping=shaping)

        ts = TimeStep(
            obs=self.observe(new_state),
            reward=reward,
            terminated=landed | crashed,
            truncated=truncated & ~(landed | crashed),
            info={
                "landed": landed,
                "crashed": crashed,
                "leg_contacts": leg_contacts,
                "fuel": main + _abs_j(side),
            },
        )
        return new_state, ts

    # -- the batched (plane-space) path --------------------------------------

    def reset_fn_batch(self, keys) -> LanderState:
        """``keys`` ``[B, 2]`` -> fresh states, each with its own terrain."""
        B = keys.shape[0]
        split = prng.split(keys)  # [B, 2, 2]
        tkeys, skeys = split[:, 0], split[:, 1]
        terrain = terrain_vertices_batch(tkeys)
        bodies = BodyState(
            *(x.expand((B,) + x.shape).contiguous() for x in self._init_bodies)
        )
        px, py = bodies.pos[:, 0, 0], bodies.pos[:, 0, 1]
        vx, vy = bodies.vel[:, 0, 0], bodies.vel[:, 0, 1]
        dist = torch.sqrt(px * px + (py - (PAD_Y + 1.0)) ** 2)
        speed = torch.sqrt(vx * vx + vy * vy)
        shaping = -dist - speed - _abs_j(bodies.angle[:, 0])
        return LanderState(
            bodies=bodies,
            terrain=terrain,
            t=torch.zeros(B, dtype=torch.int32, device=keys.device),
            key=skeys.contiguous(),
            prev_shaping=shaping,
            leg_contacts=torch.zeros((B, 2), dtype=torch.float32, device=keys.device),
        )

    # -- plane hooks ----------------------------------------------------

    def plane_pack(self, states: LanderState) -> LanderAux:
        B = states.t.shape[0]
        tp = states.terrain.T.reshape(N_TERRAIN, MAX_VERTS, 2, B)
        return LanderAux(
            tox=tp[:, :, 0, :].contiguous(),
            toy=tp[:, :, 1, :].contiguous(),
            prev_shaping=states.prev_shaping,
            lc=states.leg_contacts.T.contiguous(),
        )

    def plane_make_state(self, bodies, aux: LanderAux, t, key) -> LanderState:
        B = t.shape[0]
        terrain = torch.stack([aux.tox, aux.toy], dim=2)  # [7, V, 2, B]
        return LanderState(
            bodies=bodies,
            terrain=terrain.permute(3, 0, 1, 2).reshape(B, -1),
            t=t,
            key=key,
            prev_shaping=aux.prev_shaping,
            leg_contacts=aux.lc.T.contiguous(),
        )

    def plane_obs(self, s: _SoA, aux: LanderAux):
        return torch.stack(
            [
                s.px[0],
                s.py[0] - PAD_Y,
                s.vx[0],
                s.vy[0],
                torch.sin(s.angle[0]),
                torch.cos(s.angle[0]),
                s.omega[0],
                aux.lc[0],
                aux.lc[1],
            ],
            dim=-1,
        )

    def _controls(self, actions, B):
        actions = actions.to(torch.float32).reshape(B, 2)
        # jnp.clip: at a bound (a saturated tanh policy gives exactly 1.0) the
        # action takes half the cotangent, as in JAX
        main = _clip_c(actions[:, 0], 0.0, 1.0)
        side = _clip_c(actions[:, 1], -1.0, 1.0)
        return main, side

    def plane_pre(self, s: _SoA, aux: LanderAux, actions) -> _SoA:
        cfg = self.config
        main, side = self._controls(actions, s.px.shape[-1])
        c0, s0 = torch.cos(s.angle[0]), torch.sin(s.angle[0])
        up = cfg.main_power * main * cfg.dt
        lateral = cfg.side_power * side * cfg.dt
        dvx = -s0 * up + c0 * lateral
        dvy = c0 * up + s0 * lateral

        def add_row0(x, d):
            return torch.cat([(x[0] + d)[None], x[1:]])

        return s._replace(
            vx=add_row0(s.vx, dvx),
            vy=add_row0(s.vy, dvy),
            omega=add_row0(s.omega, -cfg.side_torque * side * cfg.dt),
        )

    def _candidate_override(self, px_pred, tox, toy):
        """Each dynamic body's terrain-candidate window.

        ``px_pred`` ``[3, B]``: bodies 0..2's x at collide time; ``tox``/
        ``toy`` ``[7, V, B]``: each world's terrain planes.  Returns the
        ``terrain_override`` of the candidate world: K consecutive segments
        a body, the window clamped into ``[0, 7-K]`` (a sliding window, so
        no segment twice: a duplicate would resolve its contact twice).
        One gather of the ``[11, V, B]`` planes; its gradient reaches the
        chosen segment only, as the JAX package's select chain sends it.
        A NaN ``px`` fails every comparison, so its window starts at 0."""
        body, j, m, last = (r[:, None] for r in self._cand_rows.T)
        x0 = tox.amin(dim=1)  # [7, B] each segment's left edge
        px = px_pred[body[:, 0]]  # [11, B]
        seg = (px[:, None, :] >= x0[None, 1:]).sum(dim=1)  # the segment px lies in
        start = (seg - m).clamp(min=0).minimum(last)
        idx = (start + j)[:, None, :].expand(-1, tox.shape[1], -1)
        cx, cy = torch.gather(tox, 0, idx), torch.gather(toy, 0, idx)
        p0 = self._cand_parts[0][0]
        return {p0 + k: (cx[k], cy[k]) for k in range(cx.shape[0])}

    def plane_physics(self, s: _SoA, aux: LanderAux):
        if self._use_candidates:
            # the collide-time x: the integrator moves positions by exactly
            # vx * dt (one multiply, then one add) before the narrow phase
            px_pred = s.px[:3] + s.vx[:3] * self.config.dt
            override = self._candidate_override(px_pred, aux.tox, aux.toy)
        else:
            override = {
                p: (aux.tox[i], aux.toy[i]) for i, p in enumerate(self._ground_parts)
            }
        return physics_core(self._bm_world, s, terrain_override=override)

    def plane_post(self, s: _SoA, aux: LanderAux, con, actions, t_new):
        cfg = self.config
        main, side = self._controls(actions, s.px.shape[-1])

        s = s._replace(omega=s.omega * self._omega_damp)

        act = con.active
        left = act[self._bm_left_leg_lanes].any(0)
        right = act[self._bm_right_leg_lanes].any(0)
        lander_contact = act[self._bm_lander_ground_lanes].any(0)

        px, py = s.px[0], s.py[0]
        vx, vy = s.vx[0], s.vy[0]
        ang, om = s.angle[0], s.omega[0]
        speed = torch.sqrt(vx * vx + vy * vy)
        dist = torch.sqrt(px * px + (py - (PAD_Y + 1.0)) ** 2)
        nlegs = left.to(px.dtype) + right.to(px.dtype)
        shaping = -dist - speed - _abs_j(ang) + 0.3 * nlegs

        landed = (
            left & right
            & (speed < cfg.landed_speed)
            & (torch.abs(om) < cfg.landed_omega)
            & (torch.abs(ang) < 0.3)
        )
        crashed = (
            lander_contact
            | (torch.abs(px) > cfg.out_x)
            | (py < cfg.out_y)
            | (torch.abs(ang) > cfg.crash_tilt)
        )
        reward = (
            shaping
            - aux.prev_shaping
            - cfg.fuel_cost_main * main
            - cfg.fuel_cost_side * _abs_j(side)
            + torch.where(landed, cfg.landed_bonus, 0.0)
            + torch.where(crashed, cfg.crash_penalty, 0.0)
        )
        terminated = landed | crashed
        lc_new = torch.stack([left, right]).to(px.dtype)  # [2, B]
        aux = LanderAux(tox=aux.tox, toy=aux.toy, prev_shaping=shaping, lc=lc_new)
        info = {
            "landed": landed,
            "crashed": crashed,
            "leg_contacts": torch.stack([left, right], dim=-1),  # [B, 2]
            "fuel": main + _abs_j(side),
        }
        return s, aux, reward, terminated, info

    def plane_fresh(self, rkeys):
        ftox, ftoy = terrain_planes_batch(rkeys, split_first=True)
        # fresh prev_shaping for reset worlds (no leg contact at spawn)
        return self._init_planes, LanderAux(
            tox=ftox, toy=ftoy, prev_shaping=self._init_shaping, lc=0.0
        )



# ---------------------------------------------------------------------------
# Continuous-time evaluation (envs/base.evaluate) on the real LunarLander:
# World forward dynamics + a dense-in-time Control + an integral-reward Judge
# ---------------------------------------------------------------------------


class LanderJudge(Judge):
    """Integral reward: R = ∫ -(dist + speed + |angle|) dt + terminal bonus.
    ``terrain_flat`` ``[..., 7*MAX_VERTS*2]``: one terrain a world."""

    def __init__(self, env: LunarLander, terrain_flat):
        self.env = env
        self.world = env._world_with_terrain(terrain_flat)
        self._last = None  # (bodies, signals) of the last call

    def _signals(self, bodies):
        # evaluate asks end_reward and is_done of the same state one after
        # the other: collide it once (what XLA's CSE does for JAX's judge)
        if self._last is not None and self._last[0] is bodies:
            return self._last[1]
        self._last = (bodies, self._landed_crashed(bodies))
        return self._last[1]

    def _landed_crashed(self, bodies):
        cfg = self.env.config
        px, py = bodies.pos[..., 0, 0], bodies.pos[..., 0, 1]
        ang = bodies.angle[..., 0]
        speed = safe_norm(bodies.vel[..., 0, :])
        left, right, lander_c = self.env._leg_flags(self.world.detect_contacts(bodies).active)
        landed = (
            left
            & right
            & (speed < cfg.landed_speed)
            & (torch.abs(bodies.omega[..., 0]) < cfg.landed_omega)
            & (torch.abs(ang) < 0.3)
        )
        crashed = (
            lander_c
            | (torch.abs(px) > cfg.out_x)
            | (py < cfg.out_y)
            | (torch.abs(ang) > cfg.crash_tilt)
        )
        return landed, crashed

    def reward(self, state, control_signal):
        b = state
        dist = safe_norm(b.pos[..., 0, :] - self.env._pad_target)
        speed = safe_norm(b.vel[..., 0, :])
        fuel = _clip_c(control_signal[..., 0], 0.0, 1.0) + _abs_j(control_signal[..., 1])
        return -(dist + speed + _abs_j(b.angle[..., 0])) - 0.3 * fuel

    def is_done(self, state, control_signal):
        landed, crashed = self._signals(state)
        return landed | crashed

    def end_reward(self, state, control_signal):
        landed, crashed = self._signals(state)
        return torch.where(landed, 100.0, 0.0) + torch.where(crashed, -100.0, 0.0)


def make_world_forward(env: LunarLander, terrain_flat):
    """``forward(bodies, control_signal, dt) -> bodies``: the continuous-time
    world dynamics (thrust + physics) for :func:`envs.base.evaluate`."""
    world = env._world_with_terrain(terrain_flat)

    def forward(bodies, signal, dt):
        main = _clip_c(signal[..., 0], 0.0, 1.0)
        side = _clip_c(signal[..., 1], -1.0, 1.0)
        bodies = env._thrust(bodies, main, side, dt)
        bodies, _ = world.step(bodies, dt=dt)
        return bodies._replace(omega=bodies.omega * env._omega_damp_n)

    return forward
