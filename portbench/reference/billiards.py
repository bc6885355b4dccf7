"""Billiards, as parallax publishes it (the JAX package's
``envs/billiards.py``): a cue ball and ``n_object`` object balls on a 2 x 1
table with four static cushions, no gravity.

* balls: radius 0.04, mass 1, inertia 2/5 r^2, elasticity 0.92, friction
  0.1; the cue at (-0.5, 0), the others racked on the right in rows 2.2 r
  apart (0.87 of that between rows), at most as many a row as the table's
  height holds, rows alternately staggered by half a gap, the apex at 0.45
  or further left where the back row needs it;
* cushions: boxes 0.1 thick around the table, elasticity 0.85;
* every step: the action (clipped to [-1, 1]) accelerates the live cue by
  3 a unit, the physics step (``symplectic``, 4 + 2 solver passes), then
  rolling friction (velocities times 0.99, potted balls frozen), potting
  (a centre within 0.09 of a corner parks the ball above the table), the
  reward (+1 an object ball potted, -1 for the cue, +2 on clearing the
  table, -0.001 a step) and termination (cue lost or table cleared);
* a reset jitters every ball by a uniform draw in [-0.002, 0.002) an axis.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import physics, threefry
from portbench.reference.physics import Bodies, Lanes, Solver, World, clip

HALF_W, HALF_H = 1.0, 0.5
BALL_R = 0.04
WALL_T = 0.1
POCKET_R = 0.09
PARK_Y = 10.0
CORNERS = np.asarray([[-HALF_W, -HALF_H], [HALF_W, -HALF_H], [-HALF_W, HALF_H], [HALF_W, HALF_H]],
                     np.float32)

# BilliardsConfig's defaults
DT, DAMPING, ACCEL = 0.01, 0.99, 3.0
ELASTICITY, WALL_ELASTICITY, FRICTION = 0.92, 0.85, 0.1
MAX_STEPS = 1000
POT_REWARD, CLEAR_BONUS, CUE_PENALTY, LIVING_COST = 1.0, 2.0, 1.0, 0.001


def rack(n_object: int) -> np.ndarray:
    gap, margin = 2.2 * BALL_R, 0.01
    per_row = int((2.0 * (HALF_H - BALL_R - margin) - gap) // gap) + 1
    rows, placed = [], 0
    while placed < n_object:
        rows.append(min(len(rows) + 1, per_row, n_object - placed))
        placed += rows[-1]
    apex = min(0.45, HALF_W - BALL_R - margin - (len(rows) - 1) * gap * 0.87)
    out = [(-0.5, 0.0)]
    for r, count in enumerate(rows):
        x = apex + r * gap * 0.87
        shift = (((r % 2) * 0.5 - (0.0 if count % 2 else 0.5)) % 1.0) * gap
        out += [(x, (i - (count - 1) / 2.0) * gap + shift) for i in range(count)]
    return np.asarray(out, np.float32)


class State(NamedTuple):
    s: Bodies  # [B, n + 4]
    potted: torch.Tensor  # [B, n] 0 or 1
    t: torch.Tensor
    key: torch.Tensor


class Billiards:
    action_size = 2
    max_steps = MAX_STEPS

    def __init__(self, device, n_object: int = 7, **config):
        if config:
            raise ValueError(f"the reference models the default billiards only, not {config}")
        n = self.n = 1 + n_object
        self.observation_size = 5 * n
        self.device = device
        w, h, t = HALF_W, HALF_H, WALL_T
        walls = np.asarray([[(-w - t, -h - t), (w + t, -h)], [(-w - t, h), (w + t, h + t)],
                            [(-w - t, -h), (-w, h)], [(w, -h), (w + t, h)]], np.float32)
        cc = [(i, j) for i in range(n) for j in range(i + 1, n)]
        cb = [(i, k) for i in range(n) for k in range(4)]
        self.world = World(
            mass=[1.0] * n + [np.inf] * 4,
            inertia=[2.0 / 5.0 * BALL_R ** 2] * n + [np.inf] * 4,
            elasticity=[ELASTICITY] * n + [WALL_ELASTICITY] * 4,
            friction=[FRICTION] * (n + 4),
            dt=DT, gravity=(0.0, 0.0), integrator="symplectic",
            solver=Solver(iterations=4, position_iterations=2),
            lanes_a=[i for i, _ in cc] + [i for i, _ in cb],
            lanes_b=[j for _, j in cc] + [n + k for _, k in cb],
            partner=[-1] * (len(cc) + len(cb)),
        )
        dev = dict(device=device)
        self.cc_a = torch.tensor([i for i, _ in cc], **dev)
        self.cc_b = torch.tensor([j for _, j in cc], **dev)
        self.cb_ball = torch.tensor([i for i, _ in cb], **dev)
        wall = np.asarray([k for _, k in cb])
        self.cb_lo = [torch.tensor(walls[wall, 0, c], **dev) for c in (0, 1)]
        self.cb_hi = [torch.tensor(walls[wall, 1, c], **dev) for c in (0, 1)]
        self.r = float(np.float32(BALL_R))
        pos = np.zeros((n + 4, 2), np.float32)
        pos[:n] = rack(n_object)
        zero = torch.zeros(n + 4, **dev)
        self.init = Bodies(torch.tensor(pos[:, 0], **dev), torch.tensor(pos[:, 1], **dev),
                           zero, zero, zero, zero)
        park = np.stack([np.linspace(-n, n, n, dtype=np.float32),
                         np.full(n, PARK_Y, np.float32)], -1)
        self.park = [torch.tensor(park[:, c], **dev) for c in (0, 1)]
        self.corners = torch.tensor(CORNERS, **dev)

    def _racked(self, keys):
        jit = threefry.uniform(keys, 2 * self.n, -0.002, 0.002).reshape(-1, self.n, 2)
        B = keys.shape[0]
        px = self.init.px.expand(B, -1)
        py = self.init.py.expand(B, -1)
        px = torch.cat([px[:, : self.n] + jit[..., 0], px[:, self.n:]], 1)
        py = torch.cat([py[:, : self.n] + jit[..., 1], py[:, self.n:]], 1)
        z = torch.zeros_like(px)
        return Bodies(px, py, z, z, z, z)

    def reset(self, keys) -> State:
        both = threefry.split(keys, 2)
        B = keys.shape[0]
        return State(self._racked(both[:, 0]), torch.zeros(B, self.n, device=keys.device),
                     torch.zeros(B, dtype=torch.int32, device=keys.device), both[:, 1])

    def fresh(self, rkeys, like: State) -> State:
        return like._replace(s=self._racked(threefry.split(rkeys, 2)[:, 0]),
                             potted=torch.zeros_like(like.potted))

    def obs(self, st: State):
        s, n = st.s, self.n
        return torch.stack([s.px[:, :n], s.py[:, :n], s.vx[:, :n], s.vy[:, :n], st.potted],
                           -1).reshape(s.px.shape[0], 5 * n)

    def float_leaves(self, st: State):
        return [*st.s, st.potted]

    def collide(self, s: Bodies) -> Lanes:
        r = self.r
        cc = physics.circle_circle(s.px[:, self.cc_a], s.py[:, self.cc_a], r,
                                   s.px[:, self.cc_b], s.py[:, self.cc_b], r)
        cb = physics.circle_box(s.px[:, self.cb_ball], s.py[:, self.cb_ball], r,
                                self.cb_lo[0], self.cb_lo[1], self.cb_hi[0], self.cb_hi[1])
        return Lanes(*(torch.cat([a, b], 1) for a, b in zip(cc, cb)))

    def step(self, st: State, actions):
        n = self.n
        a = clip(actions, -1.0, 1.0)
        live = 1.0 - st.potted[:, 0]
        s = st.s
        s = s._replace(vx=_add_col0(s.vx, a[:, 0] * ACCEL * DT * live),
                       vy=_add_col0(s.vy, a[:, 1] * ACCEL * DT * live))
        s, _ = physics.step(self.world, s, self.collide)

        damp = torch.where(st.potted > 0.5, torch.zeros_like(st.potted), torch.full_like(st.potted, DAMPING))
        vx, vy = s.vx[:, :n] * damp, s.vy[:, :n] * damp
        px, py = s.px[:, :n], s.py[:, :n]
        ddx = px[..., None] - self.corners[:, 0]
        ddy = py[..., None] - self.corners[:, 1]
        hit = (ddx * ddx + ddy * ddy).amin(-1) <= POCKET_R ** 2
        new = hit & (st.potted < 0.5)
        potted = torch.where(new, torch.ones_like(st.potted), st.potted)
        zero = torch.zeros_like(px)
        px = torch.where(new, self.park[0], px)
        py = torch.where(new, self.park[1], py)
        vx, vy = torch.where(new, zero, vx), torch.where(new, zero, vy)
        s = s._replace(px=torch.cat([px, s.px[:, n:]], 1), py=torch.cat([py, s.py[:, n:]], 1),
                       vx=torch.cat([vx, s.vx[:, n:]], 1), vy=torch.cat([vy, s.vy[:, n:]], 1))

        cue_lost = potted[:, 0] > 0.5
        cleared = (potted[:, 1:] > 0.5).all(-1)
        z = torch.zeros_like(potted[:, 0])
        reward = (POT_REWARD * new[:, 1:].sum(-1).float() - CUE_PENALTY * new[:, 0].float()
                  + torch.where(cleared & new[:, 1:].any(-1), z + CLEAR_BONUS, z) - LIVING_COST)
        return st._replace(s=s, potted=potted), reward, cue_lost | cleared

    # -- the program's state, read by its published fields ----------------

    def from_program(self, ps) -> State:
        b = ps.bodies
        s = Bodies(b.pos[..., 0], b.pos[..., 1], b.vel[..., 0], b.vel[..., 1], b.angle, b.omega)
        return State(Bodies(*(x.detach().clone() for x in s)), ps.potted.float(),
                     ps.t.clone(), ps.key.clone())

    def program_fields(self, ps) -> dict:
        b = ps.bodies
        return {"pos": b.pos, "vel": b.vel, "angle": b.angle, "omega": b.omega,
                "potted": ps.potted, "t": ps.t, "key": ps.key}

    def fields(self, st: State) -> dict:
        s = st.s
        return {"pos": torch.stack([s.px, s.py], -1), "vel": torch.stack([s.vx, s.vy], -1),
                "angle": s.ang, "omega": s.om, "potted": st.potted > 0.5, "t": st.t,
                "key": st.key}


def _add_col0(x, d):
    return torch.cat([(x[:, 0] + d)[:, None], x[:, 1:]], 1)
