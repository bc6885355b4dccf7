"""LunarLander, as parallax publishes it (the JAX package's
``envs/lunar_lander.py``, after the cotix ``_lunar_lander.py`` it follows):
a six-sided hull with two jointed legs over a terrain of seven quads that
every world draws from its own key.

* bodies: 0 the hull (mass and inertia 30, friction 0.1), 1 the right leg
  and 2 the left leg (mass and inertia 1, friction 0.1), 3 the ground
  (static, elasticity 0.1, friction 0.1, one quad part a terrain segment);
* joints: hull to left leg twice, hull to right leg twice, springs with
  ``kp`` 1, ``kd`` 0.05, ``v0`` 0.1;
* every step: the engines' kick on the hull, the physics step
  (``reference`` integrator, gravity 0.2 down, 3 + 2 solver passes), the
  legs' spin damped by 0.95, then reward, termination and observation.

The terrain: keys split in five; eight heights uniform in [-5, 5] (the
first and last times ten, the pad's two at -2), x at -100, [-12, -9),
[-8, -4), -2, 2, [4, 8), [9, 12), 100; segment ``i`` is the quad of
``(x_i, h_i), (x_i, -10), (x_i+1, h_i+1), (x_i+1, -10)`` in ascending order
of a diamond pseudo-angle about its centre (a stable sort).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import physics, threefry
from portbench.reference.physics import Bodies, Joint, Lanes, Solver, World, abs_, clip

SCALE = 0.05
HULL = np.array([(-14, 17), (-17, 0), (-17, -10), (17, -10), (17, 0), (14, 17)], np.float32)
LEG_AWAY, LEG_DOWN, LEG_W, LEG_H, LEG_ANGLE = 24, 8, 2, 8, -0.3
N_TERRAIN = 7
PAD_Y = -2.0
PADDED = 8  # the program's terrain layout: each quad repeat-padded to 8 vertices

# LanderConfig's defaults
DT, GRAVITY = 0.01, 0.2
MAIN_POWER, SIDE_POWER, SIDE_TORQUE = 0.5, 0.1, 0.6
FUEL_MAIN, FUEL_SIDE = 0.03, 0.003
MAX_STEPS = 1000
LEG_DAMPING = 0.95
LANDED_SPEED, LANDED_OMEGA, CRASH_TILT = 0.08, 0.2, 1.4
OUT_X, OUT_Y = 15.0, -9.5
LANDED_BONUS, CRASH_PENALTY = 10.0, -10.0


def _ordered(v):
    """A polygon's vertices in ascending atan2 order about their mean."""
    v = np.asarray(v, np.float32)
    rel = v - v.mean(0, dtype=np.float32)
    return v[np.argsort(np.arctan2(rel[:, 1], rel[:, 0]), kind="stable")]


def _leg(side):
    v = np.array([(-LEG_W, -LEG_H), (LEG_W, -LEG_H), (LEG_W, LEG_H), (-LEG_W, LEG_H)], np.float32)
    a = LEG_ANGLE
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]], np.float32)
    v = (v @ rot) * SCALE
    return v * np.array([-1.0, 1.0], np.float32) if side < 0 else v


def _padded(v, n):
    return np.concatenate([v, np.repeat(v[-1:], n - len(v), 0)])


class State(NamedTuple):
    s: Bodies  # [B, 4]
    tx: torch.Tensor  # [B, 7, 4] terrain x, world frame
    ty: torch.Tensor
    prev_shaping: torch.Tensor  # [B]
    lc: torch.Tensor  # [B, 2] last step's (left, right) leg contacts, 0 or 1
    t: torch.Tensor  # [B] int
    key: torch.Tensor  # [B, 2] int64 words


class LunarLander:
    observation_size = 9
    action_size = 2
    max_steps = MAX_STEPS

    def __init__(self, device, **config):
        unknown = set(config) - {"broadphase", "use_cuda_fused"}
        if unknown or config.get("broadphase", True) or not config.get("use_cuda_fused", False):
            raise ValueError(f"the reference models the fused lander only, not {config}")
        self.device = device
        hull = _ordered(HULL * SCALE)
        legs = [_ordered(_leg(-1)), _ordered(_leg(+1))]  # right, left
        # A sides: hull (6 vertices) or a leg; B sides: a leg or a terrain quad
        self.local = [tuple(torch.tensor(v[:, i], device=device) for i in (0, 1))
                      for v in (_padded(hull, 6), _padded(legs[0], 6), _padded(legs[1], 6))]
        self.pairs = ([(0, 1), (0, 2)] + [(0, 3 + k) for k in range(N_TERRAIN)]
                      + [(1, 2)] + [(1, 3 + k) for k in range(N_TERRAIN)]
                      + [(2, 3 + k) for k in range(N_TERRAIN)])
        body_of = lambda part: min(part, 3)
        lanes_a = [body_of(a) for a, _ in self.pairs for _ in (0, 1)]
        lanes_b = [body_of(b) for _, b in self.pairs for _ in (0, 1)]
        partner = [c + 1 if c % 2 == 0 else c - 1 for c in range(2 * len(self.pairs))]
        f = lambda x: float(np.float32(x))
        away, down = f(LEG_AWAY * SCALE), f(-LEG_DOWN * SCALE)
        up, leg_y = f((-LEG_DOWN + 8) * SCALE), f(-LEG_DOWN * SCALE + 5.0)
        self.world = World(
            mass=[30.0, 1.0, 1.0, np.inf], inertia=[30.0, 1.0, 1.0, np.inf],
            elasticity=[1.0, 1.0, 1.0, 0.1], friction=[0.1, 0.1, 0.1, 0.1],
            dt=DT, gravity=(0.0, -GRAVITY), integrator="reference",
            solver=Solver(iterations=3, position_iterations=2),
            lanes_a=lanes_a, lanes_b=lanes_b, partner=partner,
            joints=[Joint(0, 2, (away, down), (0.0, 0.0)), Joint(0, 2, (away, up), (0.0, f(0.4))),
                    Joint(0, 1, (-away, down), (0.0, 0.0)), Joint(0, 1, (-away, up), (0.0, f(0.4)))],
        )
        self.edges_a = torch.tensor(np.stack([_edge_mask(6 if a == 0 else 4, 6) for a, _ in self.pairs]),
                                    device=device)
        self.edges_b = torch.tensor(np.ones((len(self.pairs), 4), bool), device=device)
        lane_body = [(lanes_a[c], lanes_b[c]) for c in range(len(lanes_a))]
        self.left = torch.tensor([set(ab) == {2, 3} for ab in lane_body], device=device)
        self.right = torch.tensor([set(ab) == {1, 3} for ab in lane_body], device=device)
        self.hull_ground = torch.tensor([set(ab) == {0, 3} for ab in lane_body], device=device)
        self.damp = torch.tensor([1.0, LEG_DAMPING, LEG_DAMPING, 1.0], dtype=torch.float32,
                                 device=device)
        self.init = Bodies(
            px=torch.tensor([0.0, -away, away, 0.0], device=device),
            py=torch.tensor([5.0, leg_y, leg_y, 0.0], device=device),
            vx=torch.zeros(4, device=device), vy=torch.zeros(4, device=device),
            ang=torch.tensor([0.01, 0.0, 0.0, 0.0], device=device),
            om=torch.zeros(4, device=device),
        )
        p0x, p0y = float(self.init.px[0]), float(self.init.py[0])
        self.init_shaping = (-float(np.sqrt(p0x * p0x + (p0y - (PAD_Y + 1.0)) ** 2))
                             - abs(float(self.init.ang[0])))

    # -- the draw ---------------------------------------------------------

    def terrain(self, keys):
        """``[B, 2]`` keys -> terrain x and y ``[B, 7, 4]``."""
        ks = threefry.split(keys, 5)  # [B, 5, 2]
        # the five keys' first eight words in one pass: the heights take
        # key 0's eight, each inner x its own key's first
        f = threefry.unit_floats(ks, 8)  # [B, 5, 8]
        h = threefry.scaled(f[:, 0], -5.0, 5.0)
        h = torch.cat([h[:, :1] * 10.0, h[:, 1:3], torch.full_like(h[:, :2], -2.0),
                       h[:, 5:7], h[:, 7:] * 10.0], 1)
        one = torch.ones_like(h[:, 0])
        u = lambda i, lo, hi: threefry.scaled(f[:, i, 0], lo, hi)
        x = torch.stack([-100.0 * one, u(1, -12.0, -9.0), u(2, -8.0, -4.0), -2.0 * one,
                         2.0 * one, u(3, 4.0, 8.0), u(4, 9.0, 12.0), 100.0 * one], 1)
        bottom = torch.full_like(x[:, :-1], -10.0)
        qx = torch.stack([x[:, :-1], x[:, :-1], x[:, 1:], x[:, 1:]], -1)
        qy = torch.stack([h[:, :-1], bottom, h[:, 1:], bottom], -1)
        dx, dy = qx - qx.mean(-1, keepdim=True), qy - qy.mean(-1, keepdim=True)
        p = dy / (abs_(dx) + abs_(dy))
        key = torch.where(dx >= 0, p, torch.where(dy >= 0, 2.0 - p, -2.0 - p))
        order = torch.sort(key, dim=-1, stable=True).indices
        return torch.gather(qx, -1, order), torch.gather(qy, -1, order)

    def _shaping(self, s, legs):
        px, py, vx, vy = s.px[:, 0], s.py[:, 0], s.vx[:, 0], s.vy[:, 0]
        dist = torch.sqrt(px * px + (py - (PAD_Y + 1.0)) * (py - (PAD_Y + 1.0)))
        speed = torch.sqrt(vx * vx + vy * vy)
        return -dist - speed - abs_(s.ang[:, 0]) + 0.3 * legs

    def reset(self, keys) -> State:
        both = threefry.split(keys, 2)
        tx, ty = self.terrain(both[:, 0])
        B = keys.shape[0]
        s = Bodies(*(x.expand(B, 4).clone() for x in self.init))
        px, py, vx, vy = s.px[:, 0], s.py[:, 0], s.vx[:, 0], s.vy[:, 0]
        shaping = (-torch.sqrt(px * px + (py - (PAD_Y + 1.0)) * (py - (PAD_Y + 1.0)))
                   - torch.sqrt(vx * vx + vy * vy) - abs_(s.ang[:, 0]))
        return State(s, tx, ty, shaping, torch.zeros(B, 2, device=keys.device),
                     torch.zeros(B, dtype=torch.int32, device=keys.device), both[:, 1])

    def fresh(self, rkeys, like: State) -> State:
        """The state an auto-reset puts in a finished world's place (its
        ``t`` and ``key`` are the driver's)."""
        tx, ty = self.terrain(threefry.split(rkeys, 2)[:, 0])
        B = rkeys.shape[0]
        s = Bodies(*(x.expand(B, 4) for x in self.init))
        return like._replace(s=s, tx=tx, ty=ty,
                             prev_shaping=torch.full_like(like.prev_shaping, self.init_shaping),
                             lc=torch.zeros_like(like.lc))

    # -- a step -----------------------------------------------------------

    def obs(self, st: State):
        s = st.s
        return torch.stack([s.px[:, 0], s.py[:, 0] - PAD_Y, s.vx[:, 0], s.vy[:, 0],
                            torch.sin(s.ang[:, 0]), torch.cos(s.ang[:, 0]), s.om[:, 0],
                            st.lc[:, 0], st.lc[:, 1]], -1)

    def float_leaves(self, st: State):
        return [*st.s, st.tx, st.ty, st.prev_shaping, st.lc]

    def collide(self, s: Bodies, tx, ty) -> Lanes:
        wx, wy = zip(*(physics.world_vertices(lx, ly, s.px[:, b], s.py[:, b], s.ang[:, b])
                       for b, (lx, ly) in enumerate(self.local)))
        bx_dyn = {b: (wx[b][:, :4], wy[b][:, :4]) for b in (1, 2)}  # legs: 4 real vertices
        ax = torch.stack([wx[a] for a, _ in self.pairs], 1)
        ay = torch.stack([wy[a] for a, _ in self.pairs], 1)
        bx = torch.stack([bx_dyn[b][0] if b < 3 else tx[:, b - 3] for _, b in self.pairs], 1)
        by = torch.stack([bx_dyn[b][1] if b < 3 else ty[:, b - 3] for _, b in self.pairs], 1)
        pen_x, pen_y, pt_x, pt_y, act = physics.polygon_manifold(
            ax, ay, self.edges_a, bx, by, self.edges_b)
        flat = lambda x: x.reshape(x.shape[0], -1)  # lanes: pair 0 point 0, pair 0 point 1, ...
        return Lanes(flat(pen_x), flat(pen_y), flat(pt_x), flat(pt_y), flat(act))

    def step(self, st: State, actions):
        """pre, physics, post: ``(state without t and key, reward,
        terminated)``."""
        main = clip(actions[:, 0], 0.0, 1.0)
        side = clip(actions[:, 1], -1.0, 1.0)
        s = st.s
        c0, s0 = torch.cos(s.ang[:, 0]), torch.sin(s.ang[:, 0])
        kick_main = MAIN_POWER * main * DT
        kick_side = SIDE_POWER * side * DT
        dvx = -s0 * kick_main + c0 * kick_side
        dvy = c0 * kick_main + s0 * kick_side
        s = s._replace(vx=_add_col0(s.vx, dvx), vy=_add_col0(s.vy, dvy),
                       om=_add_col0(s.om, -SIDE_TORQUE * side * DT))

        s, con = physics.step(self.world, s, lambda q: self.collide(q, st.tx, st.ty))
        s = s._replace(om=s.om * self.damp)

        act = con.active
        left = (act & self.left).any(-1)
        right = (act & self.right).any(-1)
        hull = (act & self.hull_ground).any(-1)
        legs = left.float() + right.float()
        shaping = self._shaping(s, legs)
        px, py, ang, om = s.px[:, 0], s.py[:, 0], s.ang[:, 0], s.om[:, 0]
        speed = torch.sqrt(s.vx[:, 0] * s.vx[:, 0] + s.vy[:, 0] * s.vy[:, 0])
        landed = (left & right & (speed < LANDED_SPEED) & (abs_(om) < LANDED_OMEGA)
                  & (abs_(ang) < 0.3))
        crashed = hull | (abs_(px) > OUT_X) | (py < OUT_Y) | (abs_(ang) > CRASH_TILT)
        zero = torch.zeros_like(shaping)
        reward = (shaping - st.prev_shaping - FUEL_MAIN * main - FUEL_SIDE * abs_(side)
                  + torch.where(landed, zero + LANDED_BONUS, zero)
                  + torch.where(crashed, zero + CRASH_PENALTY, zero))
        new = st._replace(s=s, prev_shaping=shaping, lc=torch.stack([left, right], -1).float())
        return new, reward, landed | crashed

    # -- the program's state, read by its published fields ----------------

    def from_program(self, ps) -> State:
        b = ps.bodies
        terrain = ps.terrain.reshape(ps.terrain.shape[0], N_TERRAIN, PADDED, 2)[:, :, :4]
        s = Bodies(b.pos[..., 0], b.pos[..., 1], b.vel[..., 0], b.vel[..., 1], b.angle, b.omega)
        return State(Bodies(*(x.detach().clone() for x in s)), terrain[..., 0].clone(),
                     terrain[..., 1].clone(), ps.prev_shaping.detach().clone(),
                     ps.leg_contacts.detach().clone(), ps.t.clone(), ps.key.clone())

    def program_fields(self, ps) -> dict:
        b = ps.bodies
        return {"pos": b.pos, "vel": b.vel, "angle": b.angle, "omega": b.omega,
                "terrain": ps.terrain, "t": ps.t, "key": ps.key,
                "prev_shaping": ps.prev_shaping, "leg_contacts": ps.leg_contacts}

    def fields(self, st: State) -> dict:
        """The state in the program's published layout."""
        s = st.s
        quads = torch.stack([st.tx, st.ty], -1)  # [B, 7, 4, 2]
        quads = torch.cat([quads, quads[:, :, 3:].expand(-1, -1, PADDED - 4, -1)], 2)
        return {"pos": torch.stack([s.px, s.py], -1), "vel": torch.stack([s.vx, s.vy], -1),
                "angle": s.ang, "omega": s.om, "terrain": quads.reshape(quads.shape[0], -1),
                "t": st.t, "key": st.key, "prev_shaping": st.prev_shaping, "leg_contacts": st.lc}


def _add_col0(x, d):
    return torch.cat([(x[:, 0] + d)[:, None], x[:, 1:]], 1)


def _edge_mask(nverts, width):
    """The real edges of an ``nverts``-gon repeat-padded to ``width``
    vertices: ``v -> v+1`` for the first ``nverts - 1``, and the closing
    edge from the last padded vertex."""
    m = np.zeros(width, bool)
    m[: nverts - 1] = True
    m[width - 1] = True
    return m
