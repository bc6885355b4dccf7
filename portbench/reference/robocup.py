"""RoboCup SSL Division B, as parallax publishes its RoboCup field (the JAX
package's ``envs/robocup.py`` and the containment lane of its
``engine/batched.py``), at six robots a team: the field, goal and ball
constants of the cotix ``_robocup.py`` it follows, robots added by parallax.

* bodies, in order: 0 the field (a static *area* box 10.4 x 7.4 that keeps
  the others inside it), 1 the play area (9 x 6, collides with nothing),
  2 the yellow goal at -x and 3 the blue goal at +x (static, three boxes
  each: a back wall 0.01 thick and two side walls over the goal's 0.2 x 1,
  elasticity 0.5, friction 1), 4 the ball (a circle of radius 0.066, mass
  0.5, inertia 1, elasticity 1, friction 0.2, spin 10 at kick-off), then
  the blue robots and the yellow robots (circles of radius 0.09, mass 2.5,
  inertia 0.02, elasticity 0.3, friction 0.5; robot ``i`` of a team at
  ``(+-(1 + 0.8 i), (i - 2.5) * 1.5)``); the field and the play area take
  elasticity and friction 1;
* the lanes: every pair of parts of different bodies, first part before
  second, except pairs with the play area, pairs of two static bodies and
  pairs of two areas; a circle with a circle is a ``cc`` lane, a circle
  with a box a ``cb`` lane (the circle first), a circle inside the area a
  containment lane (the circle first); ``cc`` lanes, then ``cb``, then
  the containment lanes, each in the order the pairs were met;
* every step: each robot's velocity moves toward its command (clipped to
  +-3) by at most ``4 * dt`` an axis, its angular velocity is set to its
  command (clipped to +-10); the physics step (``reference`` integrator,
  no gravity, 3 + 2 solver passes, dt 0.01); the ball's velocity times
  0.995; a goal when the ball's centre is past the goal line by its radius
  and inside the mouth (|y| < 0.5): +1 for blue at -x, -1 for yellow at
  +x, plus ``-0.01 * x * dt`` of the ball's progress; a goal terminates;
* the observation: the ball's position and velocity, every robot's
  position (x, y interleaved), every robot's velocity;
* the kick-off: the key splits in two, the first drawing the ball's
  direction uniform in [0, 2 pi) at speed 1, the second carried on.

Departures from the JAX package's semantics: none in the values.  The
configuration's broadphase (on, the default) is not modelled: the
package's circle and containment lanes mask themselves and take no
broadphase.  The containment lane's deepest side is found by ``argmax``
over the four sides, whose first maximum is the package's tie order
(right, top, left, bottom).  Only the configuration of
``portbench/configs/robocup.json`` is modelled, and any other is refused.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import physics, threefry
from portbench.reference.physics import Bodies, Lanes, Solver, World, clip

FIELD = (10.4, 7.4)
PLAY_AREA = (9.0, 6.0)
GOAL = (0.2, 1.0)
GOAL_WALL = 0.01
BALL_R = 0.022 * 3
ROBOT_R = 0.09

# RoboCupConfig's defaults
DT = 0.01
MAX_STEPS = 2000
MAX_SPEED, MAX_ACCEL, MAX_OMEGA = 3.0, 4.0, 10.0
BALL_DAMPING = 0.995
GOAL_REWARD, SHAPING = 1.0, 0.01

CONFIG = {"n_robots_per_team": 6, "use_cuda_fused": True}
CIRCLE, BOX, AREA = "circle", "box", "area"


def goal_walls(side: int):
    """The three boxes ``(lo, hi)`` of one goal: side -1 the yellow goal at
    -x, +1 its mirror."""
    lo = np.array([-PLAY_AREA[0] / 2 - GOAL[0], -GOAL[1] / 2])
    hi = np.array([-PLAY_AREA[0] / 2, GOAL[1] / 2])
    walls = [(lo, lo + np.array([GOAL_WALL, GOAL[1]])),
             (lo + np.array([GOAL_WALL, 0.0]), lo + np.array([GOAL[0], GOAL_WALL])),
             (hi - np.array([GOAL[0], GOAL_WALL]), hi)]
    if side > 0:
        walls = [((-u[0], l[1]), (-l[0], u[1])) for l, u in walls]
    return [(np.float32(l), np.float32(u)) for l, u in walls]


def area_cb(cx, cy, r, lx, ly, ux, uy):
    """A circle ``[B, G]`` held inside an area box: pushed back by how far
    it pokes past each side (right, top, left, bottom), active where it
    pokes past any; the contact point is the circle's extreme point toward
    the side it pokes furthest past (the first of the four on a tie)."""
    past = torch.stack([cx + r - ux, cy + r - uy, lx - (cx - r), ly - (cy - r)], -1)
    over = past.clamp_min(0.0)
    active = over.amax(-1) > 0
    pen_x = (over[..., 2] - over[..., 0]) * active
    pen_y = (over[..., 3] - over[..., 1]) * active
    side = past.argmax(-1)
    r = torch.as_tensor(r, dtype=cx.dtype, device=cx.device).expand_as(cx)
    zero = torch.zeros_like(cx)
    pt_x = cx + torch.stack([r, zero, -r, zero], -1).gather(-1, side[..., None])[..., 0]
    pt_y = cy + torch.stack([zero, r, zero, -r], -1).gather(-1, side[..., None])[..., 0]
    return pen_x, pen_y, pt_x, pt_y, active


class State(NamedTuple):
    s: Bodies  # [B, 17]
    t: torch.Tensor  # [B] int
    key: torch.Tensor  # [B, 2] int64 words


class RoboCup:
    max_steps = MAX_STEPS
    ball_damping = BALL_DAMPING

    def __init__(self, device, **config):
        if config != CONFIG:
            raise ValueError(f"the reference models RoboCup Division B fused only, not {config}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = device
        n = CONFIG["n_robots_per_team"]
        self.ball = 4
        self.robots = torch.arange(5, 5 + 2 * n, device=device)
        self.n_robots = 2 * n
        self.action_size = 3 * self.n_robots
        self.observation_size = 4 + 4 * self.n_robots

        half = lambda dims: (np.float32(-np.array(dims) / 2), np.float32(np.array(dims) / 2))
        # parts: (kind, body, geometry); a circle's radius, a box's (lo, hi)
        parts = [(AREA, 0, half(FIELD)), (AREA, 1, half(PLAY_AREA))]
        parts += [(BOX, 2, w) for w in goal_walls(-1)] + [(BOX, 3, w) for w in goal_walls(+1)]
        parts += [(CIRCLE, 4, np.float32(BALL_R))]
        parts += [(CIRCLE, 5 + i, np.float32(ROBOT_R)) for i in range(2 * n)]
        static = [True] * 4 + [False] * (1 + 2 * n)
        kinds = {"cc": [], "cb": [], "area_cb": []}
        for p in range(len(parts)):
            for q in range(p + 1, len(parts)):
                (kp, bp, _), (kq, bq, _) = parts[p], parts[q]
                if bp == bq or 1 in (bp, bq) or (static[bp] and static[bq]):
                    continue
                if AREA in (kp, kq):
                    if kp != kq:
                        kinds["area_cb"].append((q, p) if kp == AREA else (p, q))
                elif kp == kq == CIRCLE:
                    kinds["cc"].append((p, q))
                else:
                    kinds["cb"].append((p, q) if kp == CIRCLE else (q, p))
        self.kinds = kinds
        order = kinds["cc"] + kinds["cb"] + kinds["area_cb"]

        dev = dict(device=device)

        def circles(idx):
            return (torch.tensor([parts[a][1] for a in idx], **dev),
                    torch.tensor(np.array([parts[a][2] for a in idx]), **dev))

        def boxes(idx):
            lo = np.array([parts[b][2][0] for b in idx])
            hi = np.array([parts[b][2][1] for b in idx])
            return [torch.tensor(x[:, c], **dev) for x in (lo, hi) for c in (0, 1)]

        self.cc = (*circles([a for a, _ in kinds["cc"]]), *circles([b for _, b in kinds["cc"]]))
        self.cb = (*circles([a for a, _ in kinds["cb"]]), *boxes([b for _, b in kinds["cb"]]))
        self.area = (*circles([a for a, _ in kinds["area_cb"]]),
                     *boxes([b for _, b in kinds["area_cb"]]))

        self.world = World(
            mass=[np.inf] * 4 + [0.5] + [2.5] * (2 * n),
            inertia=[np.inf] * 4 + [1.0] + [0.02] * (2 * n),
            elasticity=[1.0, 1.0, 0.5, 0.5, 1.0] + [0.3] * (2 * n),
            friction=[1.0, 1.0, 1.0, 1.0, 0.2] + [0.5] * (2 * n),
            dt=DT, gravity=(0.0, 0.0), integrator="reference",
            solver=Solver(iterations=3, position_iterations=2),
            lanes_a=[parts[a][1] for a, _ in order], lanes_b=[parts[b][1] for _, b in order],
            partner=[-1] * len(order),
        )
        nb = 5 + 2 * n
        x = np.zeros(nb, np.float32)
        y = np.zeros(nb, np.float32)
        for team, sign in enumerate((1.0, -1.0)):
            for i in range(n):
                x[5 + team * n + i] = sign * (1.0 + i * 0.8)
                y[5 + team * n + i] = (i - (n - 1) / 2) * 1.5
        om = np.zeros(nb, np.float32)
        om[self.ball] = 10.0
        zero = torch.zeros(nb, **dev)
        self.init = Bodies(torch.tensor(x, **dev), torch.tensor(y, **dev), zero, zero, zero,
                           torch.tensor(om, **dev))

    # -- the kick-off ---------------------------------------------------

    def _kickoff(self, ball_keys) -> Bodies:
        ang = threefry.uniform(ball_keys, 1, 0.0, 2 * np.pi)[:, 0]
        B = ball_keys.shape[0]
        s = Bodies(*(x.expand(B, -1).clone() for x in self.init))
        s.vx[:, self.ball] = torch.cos(ang)
        s.vy[:, self.ball] = torch.sin(ang)
        return s

    def reset(self, keys) -> State:
        both = threefry.split(keys, 2)
        return State(self._kickoff(both[:, 0]),
                     torch.zeros(keys.shape[0], dtype=torch.int32, device=keys.device), both[:, 1])

    def fresh(self, rkeys, like: State) -> State:
        return like._replace(s=self._kickoff(threefry.split(rkeys, 2)[:, 0]))

    # -- the step -------------------------------------------------------

    def obs(self, st: State):
        s, ri, b = st.s, self.robots, self.ball
        B = s.px.shape[0]
        pos = torch.stack([s.px[:, ri], s.py[:, ri]], -1).reshape(B, -1)
        vel = torch.stack([s.vx[:, ri], s.vy[:, ri]], -1).reshape(B, -1)
        ball = torch.stack([s.px[:, b], s.py[:, b], s.vx[:, b], s.vy[:, b]], -1)
        return torch.cat([ball, pos, vel], -1)

    def float_leaves(self, st: State):
        return list(st.s)

    def collide(self, s: Bodies) -> Lanes:
        ia, ra, ib, rb = self.cc
        cc = physics.circle_circle(s.px[:, ia], s.py[:, ia], ra, s.px[:, ib], s.py[:, ib], rb)
        ic, rc, *box = self.cb
        cb = physics.circle_box(s.px[:, ic], s.py[:, ic], rc, *box)
        ia, ra, *field = self.area
        inside = area_cb(s.px[:, ia], s.py[:, ia], ra, *field)
        return Lanes(*(torch.cat(parts, 1) for parts in zip(cc, cb, inside)))

    def track(self, s: Bodies, actions) -> Bodies:
        """The robots' velocity tracking under the acceleration limit."""
        a = actions.to(torch.float32).reshape(-1, self.n_robots, 3)
        lim = MAX_ACCEL * DT
        ri = self.robots
        dvx = clip(clip(a[..., 0], -MAX_SPEED, MAX_SPEED) - s.vx[:, ri], -lim, lim)
        dvy = clip(clip(a[..., 1], -MAX_SPEED, MAX_SPEED) - s.vy[:, ri], -lim, lim)
        vx, vy, om = s.vx.clone(), s.vy.clone(), s.om.clone()
        vx[:, ri] = s.vx[:, ri] + dvx
        vy[:, ri] = s.vy[:, ri] + dvy
        om[:, ri] = clip(a[..., 2], -MAX_OMEGA, MAX_OMEGA)
        return s._replace(vx=vx, vy=vy, om=om)

    def step(self, st: State, actions):
        s = self.track(st.s, actions)
        s, _ = physics.step(self.world, s, self.collide)
        b = self.ball
        vx, vy = s.vx.clone(), s.vy.clone()
        vx[:, b] = s.vx[:, b] * self.ball_damping
        vy[:, b] = s.vy[:, b] * self.ball_damping
        s = s._replace(vx=vx, vy=vy)

        bx, by = s.px[:, b], s.py[:, b]
        line = PLAY_AREA[0] / 2
        mouth = torch.abs(by) < GOAL[1] / 2
        blue = (bx < -(line + BALL_R)) & mouth  # into the yellow goal
        yellow = (bx > (line + BALL_R)) & mouth
        zero = torch.zeros_like(bx)
        reward = (torch.where(blue, zero + GOAL_REWARD, zero)
                  - torch.where(yellow, zero + GOAL_REWARD, zero) + (-SHAPING * bx) * DT)
        return st._replace(s=s), reward, blue | yellow

    # -- the program's state, read by its published fields ----------------

    def from_program(self, ps) -> State:
        b = ps.bodies
        s = Bodies(b.pos[..., 0], b.pos[..., 1], b.vel[..., 0], b.vel[..., 1], b.angle, b.omega)
        return State(Bodies(*(x.detach().clone() for x in s)), ps.t.clone(), ps.key.clone())

    def program_fields(self, ps) -> dict:
        b = ps.bodies
        return {"pos": b.pos, "vel": b.vel, "angle": b.angle, "omega": b.omega,
                "t": ps.t, "key": ps.key}

    def fields(self, st: State) -> dict:
        s = st.s
        return {"pos": torch.stack([s.px, s.py], -1), "vel": torch.stack([s.vx, s.vy], -1),
                "angle": s.ang, "omega": s.om, "t": st.t, "key": st.key}
