"""Scenarios that the port's CPU tests and its card tests share.

Plain torch and numpy, no jax: ``tests/test_torch_cuda.py`` imports this
module on a machine without jax.  Every input comes from a numpy seed.
"""

import numpy as np
import torch

from parallax_tpu_torch.engine import batched as tb

# the lander's gravity times dt: a movable body that starts with this vy
# leaves the integration at rest (reference integrator)
_GRAVITY_DT = 0.2 * 0.01


def cotangents(n, B, seed=5, device="cpu"):
    """Six ``[n, B]`` cotangent planes from a numpy seed."""
    rng = np.random.default_rng(seed)
    return tb._SoA(*(torch.from_numpy(rng.standard_normal((n, B)).astype(np.float32)).to(device)
                     for _ in range(6)))


def lander_contact_case(env, B, device="cpu"):
    """The lander's contact scenario: reset from numpy-seeded keys, lowered
    by 6.2 with vy -= 0.6, after 40 zero-action steps, so that legs and hull
    touch the terrain.  Returns ``(s, override)``: the ``_SoA`` body planes
    and the terrain-override planes ``{part: (x, y)}`` of the ground."""
    k = np.random.default_rng(0).integers(0, 2**32, (B, 2), dtype=np.uint32)
    st = env.reset_fn_batch(torch.from_numpy(k.astype(np.int64)).to(device))
    b = st.bodies
    st = st._replace(bodies=b._replace(
        pos=b.pos - torch.tensor([0.0, 6.2], device=device),
        vel=b.vel - torch.tensor([0.0, 0.6], device=device),
    ))

    def zero(_, obs):
        return torch.zeros((obs.shape[0], 2), device=obs.device)

    st, _ = env.rollout_batch(st, zero, 40)
    aux = env.plane_pack(st)
    override = {p: (aux.tox[i], aux.toy[i]) for i, p in enumerate(env._ground_parts)}
    return tb._to_soa(st.bodies), override


def tie_solve_case(env, device="cpu"):
    """The clamp-tie case of the solve, on the lander world at B=1: every
    body at rest at its spawn pose and one active lane, lane 4 (the hull
    against the first terrain segment), whose partner lane 5 is inactive,
    so it takes the single-lane path; its penetration (0, 0.001) is under
    the 0.005 slop.  The first normal pass's ``jn + rhs * inv_kn`` and the
    first position pass's ``pj + rhs * inv_kn`` are then exactly 0, the tie
    of ``max(., 0)``.  Returns ``(s, con, cotangents)``."""
    world = env.world
    C, n = world.table.n_contacts, world.n_bodies
    ib = env._init_bodies
    zero = torch.zeros((n, 1), device=device)
    s = tb._SoA(px=ib.pos[:, 0:1].contiguous().to(device),
                py=ib.pos[:, 1:2].contiguous().to(device), vx=zero, vy=zero,
                angle=ib.angle[:, None].contiguous().to(device), omega=zero)
    planes = {k: torch.zeros((C, 1), device=device) for k in ("pen_x", "pen_y", "pt_x", "pt_y")}
    planes["pen_y"][4] = 0.001
    planes["pt_x"][4] = 0.3
    planes["pt_y"][4] = float(ib.pos[0, 1]) - 0.5
    active = torch.zeros((C, 1), dtype=torch.bool, device=device)
    active[4] = True
    con = tb.ContactsBM(**planes, active=active, weight=torch.ones((C, 1), device=device))
    return s, con, cotangents(n, 1, device=device)


def tie_fused_case(env, device="cpu"):
    """The clamp-tie case of the fused step, on the broadphase-off lander at
    B=1: the hull at its spawn angle (0.01) with its lower bottom corner
    0.001 into the landing pad (terrain from a numpy-seeded key), the legs
    3 above it, and every movable body with vy = g dt, so that it is at
    rest after the integration.  The hull then has one active lane whose
    partner is inactive (the other corner is 0.017 above the pad), under
    the slop, at zero approach velocity: the solve's ties of the
    single-lane case.  Returns ``(s, override, cotangents)``."""
    from parallax_tpu_torch.envs.lunar_lander import terrain_planes_batch

    key = np.random.default_rng(0).integers(0, 2**32, (1, 2), dtype=np.uint32)
    tox, toy = terrain_planes_batch(torch.from_numpy(key.astype(np.int64)).to(device))
    override = {p: (tox[i], toy[i]) for i, p in enumerate(env._ground_parts)}
    a = np.float32(0.01)
    # the corner (-0.85, -0.5) of the hull, rotated, ends 0.001 under y = -2
    py = -2.001 + 0.5 * float(np.cos(a)) + 0.85 * float(np.sin(a)) - _GRAVITY_DT * 0.01

    def col(*v):
        return torch.tensor(v, dtype=torch.float32, device=device)[:, None]

    s = tb._SoA(px=col(0.0, -1.2, 1.2, 0.0), py=col(py, py + 3.0, py + 3.0, 0.0),
                vx=col(0.0, 0.0, 0.0, 0.0), vy=col(*([_GRAVITY_DT] * 3), 0.0),
                angle=col(0.01, 0.0, 0.0, 0.0), omega=col(0.0, 0.0, 0.0, 0.0))
    return s, override, cotangents(env.world.n_bodies, 1, device=device)


# the mixed world's filtered body pairs
MIXED_FILTER = [(0, 2), (0, 3), (1, 2), (1, 3), (0, 4)]


def mixed_bodies(BodyDef, box, circle, polygon):
    """The mixed world's bodies, in either package's types."""
    sq = [(-0.3, -0.3), (0.3, -0.3), (0.3, 0.3), (-0.3, 0.3)]
    return [
        BodyDef(shapes=[polygon(sq)], position=(0.0, 1.0)),
        BodyDef(shapes=[polygon([(-2, -0.5), (2, -0.5), (2, 0.5), (-2, 0.5)])],
                mass=np.inf, inertia=np.inf, position=(0.0, 0.3)),
        BodyDef(shapes=[circle(0.2)], position=(3.0, 0.0)),
        BodyDef(shapes=[circle(0.2)], position=(3.3, 0.0)),
        BodyDef(shapes=[box((2.0, -0.5), (5.0, -0.2))], mass=np.inf, inertia=np.inf),
    ]


def mixed_world(device="cpu", **config):
    """A fused-step world that mixes pair groups: two polygons (one static),
    two circles and a static box, the circles filtered from the polygons
    and the moving polygon from the box.  Its groups are cc, cb and pp, in
    that lane order (1 + 2 + 2 lanes).  ``config`` updates its
    WorldConfig (broadphase off, the fused step)."""
    from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
    from parallax_tpu_torch.geometry.shapes import box, circle, polygon

    cfg = {"broadphase": False, "use_cuda_fused": True, **config}
    return World.build(mixed_bodies(BodyDef, box, circle, polygon), WorldConfig(**cfg),
                       collision_filter=MIXED_FILTER, device=device)


def mixed_state(world, state, B, seed=0):
    """``B`` worlds of :func:`mixed_world`: the movable bodies shaken by
    numpy-seeded noise, sunk into their supports so that every group's
    lanes fire in most worlds (the square starts 0.1 into its ground)."""
    rng = np.random.default_rng(seed)
    dev = state.pos.device
    s = tb._to_soa(type(state)(*(x[None].expand((B,) + x.shape) for x in state)))
    mov = torch.tensor([not st for st in world.static_bodies], device=dev)[:, None]

    def noise(scale):
        return torch.from_numpy(rng.standard_normal(s.px.shape).astype(np.float32) * scale).to(dev)

    sink = torch.tensor([0.0, 0.0, 0.05, 0.05, 0.0], device=dev)[:, None]
    return s._replace(
        px=torch.where(mov, s.px + noise(0.02), s.px),
        py=torch.where(mov, s.py - sink + noise(0.01), s.py),
        vx=torch.where(mov, noise(0.1), s.vx), vy=torch.where(mov, noise(0.1), s.vy),
        # the square stays level: its face contact's friction block is then
        # exactly singular, far from the solver's near-singular threshold
        angle=s.angle,
        omega=torch.where(mov, noise(0.1), s.omega),
    )


def overlap_state(env, B, seed, edge_x, spacing, y_step):
    """Reset states with the movable bodies piled on each other near the
    table's +x edge, so that ball-ball and ball-wall lanes fire: the torch
    twin of ``tests/test_pallas_solver.py:458`` ``_overlap_state``, with the
    reset keys from a numpy seed."""
    dev = env.device
    k = np.random.default_rng(seed).integers(0, 2**32, (B, 2), dtype=np.uint32)
    st = env.reset_fn_batch(torch.from_numpy(k.astype(np.int64)).to(dev))
    s = tb._to_soa(st.bodies)
    n = s.px.shape[0]
    ar = torch.arange(B, dtype=torch.float32, device=dev)
    jit_x = 0.01 * torch.sin(ar)[None]
    jit_y = 0.01 * torch.cos(ar)[None]
    rows = torch.arange(n, dtype=torch.float32, device=dev)[:, None]
    static = torch.tensor(env.world.static_bodies, device=dev)[:, None]
    px = edge_x - spacing * rows + jit_x
    py = y_step * rows - y_step * n / 2 + jit_y
    vx = 0.5 - 0.1 * rows
    vy = 0.3 - 0.05 * rows
    return s._replace(
        px=torch.where(static, s.px, px), py=torch.where(static, s.py, py),
        vx=torch.where(static, s.vx, vx), vy=torch.where(static, s.vy, vy),
    )


# RoboCup's overlap layout at the +x edge, (x, y) of the ball and of the
# first four robots: the ball and robot 0 touch each other and poke past the
# field's right edge (x = 5.2); robot 1 sits in the blue goal's back wall,
# robot 2 in its top wall and robot 3 in its back wall, touching robot 2.
# Every contact is at least 0.01 deep, beyond the jitter.  The other robots
# keep their kick-off places.
_RC_EDGE = np.float32([[5.17, 0.60], [5.15, 0.74], [4.75, 0.00], [4.55, 0.45], [4.62, 0.33]])


def robocup_overlap_state(env, B, seed=0):
    """RoboCup worlds where every kind of lane fires: the layout above in
    the first quarter of the worlds, mirrored onto the yellow goal and the
    left edge in the second, and turned onto the top and bottom edges
    (x <- y, y <- +-(x - 1.5)) in the last two, so that the ball pokes past
    each of the field's four sides and the contained circles' lanes take
    each wall.  Every movable body gets numpy-seeded jitter (0.003) and
    velocity (0.3).  Returns an ``_SoA``."""
    rng = np.random.default_rng(seed)
    dev = env.device
    keys = rng.integers(0, 2**32, (B, 2), dtype=np.uint32)
    s = tb._to_soa(env.reset_fn_batch(torch.from_numpy(keys.astype(np.int64)).to(dev)).bodies)
    n = s.px.shape[0]
    rows = range(env.ball_idx, env.ball_idx + len(_RC_EDGE))
    x, y = s.px.cpu().numpy(), s.py.cpu().numpy()
    q = np.arange(B) * 4 // B  # each world's quarter
    for r, (ex, ey) in zip(rows, _RC_EDGE):
        for k, (nx, ny) in enumerate(((ex, ey), (-ex, ey), (ey, ex - 1.5), (ey, 1.5 - ex))):
            x[r, q == k], y[r, q == k] = nx, ny
    mov = ~np.asarray(env.world.static_bodies)[:, None]
    jit = rng.uniform(-0.003, 0.003, (2, n, B)).astype(np.float32)
    vel = (0.3 * rng.standard_normal((2, n, B))).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return s._replace(
        px=t(np.where(mov, x + jit[0], x)), py=t(np.where(mov, y + jit[1], y)),
        vx=t(np.where(mov, vel[0], 0.0)), vy=t(np.where(mov, vel[1], 0.0)),
    )


def _at_rest(env, device):
    """The env's kick-off bodies, one world, every body at rest: ``_SoA``."""
    ib = env._init_bodies
    zero = torch.zeros((ib.pos.shape[0], 1), device=device)
    return tb._SoA(px=ib.pos[:, 0:1].contiguous().to(device),
                   py=ib.pos[:, 1:2].contiguous().to(device), vx=zero, vy=zero,
                   angle=ib.angle[:, None].contiguous().to(device), omega=zero)


def _row(x, i, v):
    x = x.clone()
    x[i] = v
    return x


def cb_tie_case(env, device="cpu"):
    """The clamp tie of a circle-box lane, on billiards at B=1: every ball at
    rest and the cue's centre exactly on the right cushion's inner face, x =
    1.0, its ``lb`` x, so that ``max(cx, lbx)`` of the clamp ties and splits
    its cotangent between the cue and the cushion.  Returns ``(s,
    cotangents)``."""
    s = _at_rest(env, device)
    s = s._replace(px=_row(s.px, 0, 1.0), py=_row(s.py, 0, 0.0))
    return s, cotangents(env.world.n_bodies, 1, device=device)


def area_tie_case(env, device="cpu"):
    """A tie of an area lane's floor, on RoboCup at B=1: every body at rest
    and the ball touching the field's right side exactly (``cx + r - ubx``
    is 0 in float32) while it pokes 0.036 past the top side, so that its
    lane is active and ``max(hx, 0)`` ties.  Returns ``(s, cotangents)``."""
    r = np.float32(env.world.parts.radius[env.world.parts.body.index(env.ball_idx)].item())
    ub = np.float32(5.2)
    cx = ub - r
    while (cx + r) - ub > 0:  # the largest centre whose right edge is ub
        cx = np.nextafter(cx, np.float32(0))
    while (cx + r) - ub < 0:
        cx = np.nextafter(cx, np.float32(10))
    assert (cx + r) - ub == 0
    s = _at_rest(env, device)
    s = s._replace(px=_row(s.px, env.ball_idx, float(cx)), py=_row(s.py, env.ball_idx, 3.67))
    return s, cotangents(env.world.n_bodies, 1, device=device)


# billiards' pairs layout: three pairs of balls touching each other (0.002
# deep) and, last, two balls against the right cushion
_PAIRS = np.float32([[-0.6, -0.039], [-0.6, 0.039], [-0.2, -0.039], [-0.2, 0.039],
                     [0.2, -0.039], [0.2, 0.039], [0.96, -0.2], [0.96, 0.2]])


def _pair_grid(n):
    """A layout of n balls for a table with more than 8: touching pairs
    0.07 apart (0.01 deep) on a 6 by 4 grid of centres 0.3 and 0.2 apart
    (an 8 by 4 grid 0.225 and 0.2 apart for more than 48 balls), clear of
    each other and of the cushions."""
    k = np.arange(n) // 2
    cols = 6 if n <= 48 else 8
    x = -0.75 + (0.3 if cols == 6 else 0.225) * (k % cols)
    y = -0.3 + 0.2 * (k // cols) + np.where(np.arange(n) % 2, 0.035, -0.035)
    return np.stack([x, y], axis=1).astype(np.float32)


def billiards_pairs_state(env, B, seed=3):
    """Billiards worlds where each ball touches one other ball or a cushion,
    no more: the layout above (a table of more than 8 balls: ``_pair_grid``,
    ball-ball pairs only) with numpy-seeded jitter (0.003), every ball
    moving at (0.3, 0.2), so that a touching pair's relative velocity is
    exactly 0 and a ball's against a cushion far from 0.  Unlike the pile
    of :func:`overlap_state`, no lane then sits near a kink (a clamp or a
    max switching its branch) that float32 rounding may cross, where two
    float32 VJPs differ by O(1): a kernel's reverse pass can be held to the
    plain version's at rtol 2e-4 in every world.  Returns an ``_SoA``."""
    rng = np.random.default_rng(seed)
    dev = env.device
    keys = rng.integers(0, 2**32, (B, 2), dtype=np.uint32)
    s = tb._to_soa(env.reset_fn_batch(torch.from_numpy(keys.astype(np.int64)).to(dev)).bodies)
    n = env.n_balls
    layout = _PAIRS if n <= len(_PAIRS) else _pair_grid(n)
    x, y = s.px.cpu().numpy(), s.py.cpu().numpy()
    x[:n] = layout[:n, 0:1] + rng.uniform(-0.003, 0.003, (n, B))
    y[:n] = layout[:n, 1:2] + rng.uniform(-0.003, 0.003, (n, B))
    v = np.zeros((2,) + x.shape, np.float32)
    v[0, :n], v[1, :n] = 0.3, 0.2

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return s._replace(px=t(x), py=t(y), vx=t(v[0]), vy=t(v[1]))


def active_kinds(world, active):
    """Active lanes of ``[C, B]`` flags ``active``, per pair kind of
    ``world``'s table."""
    from parallax_tpu_torch.ops.fused_step import _width

    out, lane = {}, 0
    for g in world.table.groups:
        width = g.size * _width(g.kernel)
        out[g.kernel] = out.get(g.kernel, 0) + int(active[lane:lane + width].sum())
        lane += width
    return out


# ---------------------------------------------------------------------------
# user-built worlds for step_batched: the crate pile, and the JAX tests'
# mixed and area worlds.  The body lists take a package's ``BodyDef``,
# ``box``, ``circle`` and ``polygon`` (the port's and the JAX package's have
# the same signatures), so that both packages build the same world.
# ---------------------------------------------------------------------------

# the crate pile's crates: half-width, half-height, mass, and the centre at
# rest on the floor (crate 1 sits on crate 0, exactly aligned, and crate 7
# on crate 6), then its centre in the overlap layout below
_CRATES = (
    (0.5, 0.5, 2.0, (-3.3, 0.5), (-3.54, 0.46)),
    (0.5, 0.5, 2.0, (-3.3, 1.5), (-3.54, 1.42)),
    (0.4, 0.4, 1.5, (-2.0, 0.4), (-2.0, 0.36)),
    (0.6, 0.4, 3.0, (-0.7, 0.4), (-0.9, 0.36)),
    (0.3, 0.3, 1.0, (0.4, 0.3), (0.3, 0.26)),
    (0.45, 0.35, 1.5, (1.4, 0.35), (1.6, 0.31)),
    (0.55, 0.5, 2.5, (2.8, 0.5), (3.49, 0.46)),
    (0.35, 0.3, 1.2, (2.8, 1.3), (3.3, 1.22)),
)
# the balls: radius, mass, centre at rest (on crates 2, 4 and 5), centre in
# the overlap layout (ball 0 on crate 2; balls 1 and 2 side by side on crate
# 3, touching)
_BALLS = (
    (0.2, 0.5, (-2.0, 1.0), (-2.0, 0.92)),
    (0.25, 0.6, (0.4, 0.85), (-1.18, 0.97)),
    (0.3, 0.8, (1.4, 1.0), (-0.6725, 1.02)),
)
N_STATIC = 3  # the floor and the two walls come first


def crate_bodies(BodyDef, box, circle, crates=8, balls=3):
    """The crate pile, a user-built scene of the kind
    ``tests/test_pallas_solver.py:519`` builds: a static floor box
    (-4, -0.5)-(4, 0) and wall boxes x in [-4.5, -4] and [4, 4.5], y in
    [0, 4]; ``crates`` dynamic axis-aligned box crates (half-widths 0.3-0.6,
    masses 1-3, a box's inertia); ``balls`` balls (radius 0.2-0.3).  All
    have friction 0.6 and elasticity 0.1.  At 8 crates and 3 balls: 14
    bodies and parts, pairs 3 cc + 33 cb + 52 bb, C=88 one-lane lanes."""
    wall = dict(mass=np.inf, inertia=np.inf, friction=0.6, elasticity=0.1)
    out = [BodyDef(shapes=[box((-4.0, -0.5), (4.0, 0.0))], **wall),
           BodyDef(shapes=[box((-4.5, 0.0), (-4.0, 4.0))], **wall),
           BodyDef(shapes=[box((4.0, 0.0), (4.5, 4.0))], **wall)]
    for hw, hh, m, pos, _ in _CRATES[:crates]:
        out.append(BodyDef(shapes=[box((-hw, -hh), (hw, hh))], mass=m,
                           inertia=m * (hw * hw + hh * hh) / 3.0, position=pos,
                           friction=0.6, elasticity=0.1))
    for r, m, pos, _ in _BALLS[:balls]:
        out.append(BodyDef(shapes=[circle(r)], mass=m, inertia=0.5 * m * r * r,
                           position=pos, friction=0.6, elasticity=0.1))
    return out


def crate_config(WorldConfig, **kw):
    """BASELINE config 3's solver (``tests/test_solver_stack.py:33``):
    symplectic, 8 velocity and 3 position iterations, the broadphase on."""
    return WorldConfig(dt=0.01, gravity=(0.0, -9.8), integrator="symplectic",
                       solver_iterations=8, position_iterations=3, **kw)


def crate_world(device="cuda", fused=False, crates=8, balls=3):
    """The crate pile as a port world: ``(world, state)``.  The split step
    runs the solver kernel on the card (``use_cuda_solver``), or with
    ``fused`` the fused step."""
    from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
    from parallax_tpu_torch.geometry.shapes import box, circle

    cfg = crate_config(WorldConfig, use_cuda_solver=not fused, use_cuda_fused=fused)
    return World.build(crate_bodies(BodyDef, box, circle, crates, balls), cfg,
                       device=device)


def crate_overlap_state(world, B, seed=0):
    """``B`` crate-pile worlds (any crate and ball counts of
    :func:`crate_bodies`) where every kind of lane fires: crates 0 and 1
    stacked, aligned, against the left wall and on the floor; crates 2-5 on
    the floor; crate 6 into the right wall with crate 7 on it; ball 0 on
    crate 2, balls 1 and 2 side by side on crate 3.  Each touching pair
    overlaps by about 0.04 and each other pair is at least 0.1 apart, beyond
    the numpy-seeded jitter (0.003) and velocities (0.05 a component)
    and one step's motion, so that every active contact is at least 0.01
    deep when it is collided; and nothing rests in an unstable balance (a
    ball on a ball rolls off along a path that rounding steers).  Crates 0
    and 1 share their jitter and velocity in x: they stay exactly aligned
    (the ties of the bb lane's contact point).  Returns an ``_SoA``."""
    rng = np.random.default_rng(seed)
    n, dev = world.n_bodies, world.device
    crates, balls = _crate_counts(world)
    lay = np.float32([(0.0, 0.0)] * N_STATIC + [c[4] for c in _CRATES[:crates]]
                     + [b[3] for b in _BALLS[:balls]])
    mov = ~np.asarray(world.static_bodies)[:, None]
    jit = rng.uniform(-0.003, 0.003, (2, n, B)).astype(np.float32)
    vel = (0.05 * rng.standard_normal((3, n, B))).astype(np.float32)
    jit[0, N_STATIC + 1] = jit[0, N_STATIC]
    vel[0, N_STATIC + 1] = vel[0, N_STATIC]
    x = np.where(mov, lay[:, 0:1] + jit[0], 0.0)
    y = np.where(mov, lay[:, 1:2] + jit[1], 0.0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return tb._SoA(px=t(x), py=t(y), vx=t(np.where(mov, vel[0], 0.0)),
                   vy=t(np.where(mov, vel[1], 0.0)), angle=t(np.zeros((n, B))),
                   omega=t(np.where(mov, vel[2], 0.0)))


def _crate_counts(world):
    """The crates and balls of a crate-pile world."""
    from parallax_tpu_torch.geometry.shapes import CIRCLE

    balls = sum(k == CIRCLE for k in world.parts.kind)
    return world.n_bodies - N_STATIC - balls, balls


def bb_tie_case(world, device="cpu"):
    """Exact ties of the bb lane, on the crate pile at B=1: crate 1 sits on
    crate 0 (0.02 deep), the two exactly aligned, so the contact point's
    ``min(uax, ubx)`` and ``max(lax, lbx)`` tie; crate 4 (a square) comes
    down and left onto a corner of crate 2 (a square), overlapping it by 0.05
    in x and in y, so that ``d0 == d2`` and the nested minimum of the four
    overlaps ties.  Both moving crates approach at 0.2 a component, the
    others float apart; every body's velocity is what it leaves the
    integration with as wanted (``vy`` starts ``-g dt`` higher), so the
    ties hold after it.  Returns ``(s, cotangents)``."""
    cfg = world.config
    gdt = np.float32(cfg.gravity[1] * cfg.dt)
    n = world.n_bodies
    x = np.zeros(n, np.float32)
    y = np.zeros(n, np.float32)
    vx = np.zeros(n, np.float32)
    vy = np.zeros(n, np.float32)  # after gravity
    c = N_STATIC
    x[c], y[c] = -3.0, 1.0  # crate 0, floating
    x[c + 1], y[c + 1], vy[c + 1] = -3.0, 1.98, -0.2  # crate 1 on it
    x[c + 2] = y[c + 2] = 1.0  # crate 2, a 0.4 square
    x[c + 4] = y[c + 4] = 1.65  # crate 4, a 0.3 square, on its corner
    vx[c + 4] = vy[c + 4] = -0.2
    for k, i in enumerate((c + 3, c + 5, c + 6, c + 7, *range(c + 8, n))):
        x[i], y[i] = -3.9 + 1.3 * k, 6.0  # the others apart, above the walls
    mov = ~np.asarray(world.static_bodies)
    vy0 = np.where(mov, vy - gdt, 0.0).astype(np.float32)
    assert ((vy0 + gdt)[mov] == vy[mov]).all()

    def col(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)[:, None]).to(device)

    zero = np.zeros(n, np.float32)
    s = tb._SoA(px=col(x), py=col(y), vx=col(vx), vy=col(vy0), angle=col(zero),
                omega=col(zero))
    return s, cotangents(n, 1, device=device)


def crate_height_loss(world, s, steps, segments=0):
    """A state objective on the crate pile: the crates' mean height after
    ``steps`` of ``step_batched`` from the ``_SoA`` ``s``, each of
    ``segments`` equal segments under ``torch.utils.checkpoint`` as the
    train path runs them (0: none).  Returns ``(loss, final _SoA)``."""
    from torch.utils.checkpoint import checkpoint

    def run(px, py, vx, vy, angle, omega, k):
        state = tb._from_soa(tb._SoA(px, py, vx, vy, angle, omega))
        for _ in range(k):
            state, _ = tb.step_batched(world, state)
        return tuple(tb._to_soa(state))

    planes = tuple(s)
    if segments:
        for _ in range(segments):
            planes = checkpoint(run, *planes, steps // segments, use_reentrant=False)
    else:
        planes = run(*planes, steps)
    out = tb._SoA(*planes)
    crates, _ = _crate_counts(world)
    return out.py[N_STATIC:N_STATIC + crates].mean(), out


def crate_kick_loss(world, s, u, steps, segments=0):
    """:func:`crate_height_loss` after the same kick ``u`` (a ``[2]``
    tensor) to every movable body's initial velocity: a state objective
    with one parameter shared by the fleet, as a policy's are.  Its
    gradient sums over the worlds, so it stays well-conditioned where a
    world's own gradient is not: at rest, contacts sit at the kinks of the
    solve (an approach velocity near 0, a friction impulse near its cone),
    and there a world's gradient wrt its own velocities moves by 1e-2
    relative under a one-ulp change of the state.  Returns ``(loss, final
    _SoA)``."""
    mov = ~torch.tensor(world.static_bodies, device=s.vx.device)[:, None]
    return crate_height_loss(world, s._replace(vx=s.vx + u[0] * mov, vy=s.vy + u[1] * mov),
                             steps, segments)


def _tri(polygon):
    return polygon([(-0.2, -0.2), (0.2, -0.2), (0.0, 0.3)])


def _area_contained(BodyDef, box, circle, polygon):
    """The three contained bodies of ``tests/test_area_containment.py:106``."""
    return [
        BodyDef(shapes=[_tri(polygon)], mass=1.0, inertia=0.1, position=(0.3, 0.1),
                velocity=(2.0, 0.5)),
        BodyDef(shapes=[box((-0.2, -0.15), (0.2, 0.15))], mass=0.8, inertia=0.08,
                position=(-0.4, 0.2), velocity=(-1.5, 1.0)),
        BodyDef(shapes=[circle(0.15)], mass=0.5, inertia=0.04, position=(0.0, -0.3),
                velocity=(1.0, -2.0)),
    ]


# the JAX tests' worlds with the pair kinds the fused kernels do not run:
# body list, WorldConfig arguments, the scales of the numpy-seeded
# perturbations of the movable bodies' position, velocity, angle and
# angular velocity (the JAX tests' own), and the movable bodies' positions
# in the odd worlds, piled onto each other (and the mixed world's onto its
# floor) so that the kinds that rarely meet under the JAX tests'
# perturbations (bp, cp, cb) fire too
KIND_WORLDS = {
    # tests/test_batched_engine.py:21: pp, cp, bp, cc and cb groups
    "mixed": (
        lambda BodyDef, box, circle, polygon: [
            BodyDef(shapes=[polygon([(-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)])],
                    mass=1.0, inertia=0.2, position=(0.0, 2.0), angle=0.2,
                    elasticity=0.3, friction=0.5),
            BodyDef(shapes=[polygon([(-0.4, -0.3), (0.5, -0.2), (0.0, 0.5)])], mass=1.5,
                    inertia=0.3, position=(0.4, 3.0), angle=-0.4, elasticity=0.2,
                    friction=0.4),
            BodyDef(shapes=[circle(0.3)], mass=0.8, inertia=0.05, position=(-0.5, 4.0),
                    elasticity=0.6, friction=0.3),
            BodyDef(shapes=[circle(0.25)], mass=0.5, inertia=0.04, position=(0.6, 4.5),
                    elasticity=0.9, friction=0.2),
            BodyDef(shapes=[box((-6.0, -2.0), (6.0, 0.0))], mass=np.inf, inertia=np.inf,
                    elasticity=0.1, friction=0.6),
            BodyDef(shapes=[polygon([(-6.0, 0.0), (-5.0, 0.0), (-5.0, 4.0), (-6.0, 4.0)])],
                    mass=np.inf, inertia=np.inf, elasticity=0.1, friction=0.6),
        ],
        dict(dt=0.01, gravity=(0.0, -9.8), integrator="symplectic", solver_iterations=8),
        (0.3, 1.0, 0.3, 1.0),
        ((0.0, 0.45), (1.1, 0.35), (-1.2, 0.25), (-0.7, 0.45)),
    ),
    # tests/test_area_containment.py:103: area_pb, area_bb, area_cb (and bp,
    # cp, cb between the contained bodies)
    "box_area": (
        lambda BodyDef, box, circle, polygon: _area_contained(BodyDef, box, circle, polygon) + [
            BodyDef(shapes=[box((-1.5, -1.0), (1.5, 1.0))], mass=np.inf, inertia=np.inf,
                    is_area=True)],
        dict(dt=0.01, gravity=(0.0, 0.0)),
        (0.8, 2.0, 0.0, 0.0),
        ((0.3, 0.1), (0.0, 0.15), (0.1, 0.0)),
    ),
    # tests/test_area_containment.py:145: area_cp, area_pp, area_bp
    "hex_area": (
        lambda BodyDef, box, circle, polygon: _area_contained(BodyDef, box, circle, polygon) + [
            BodyDef(shapes=[polygon([(2.0, 0.0), (1.0, 1.7), (-1.0, 1.7), (-2.0, 0.0),
                                     (-1.0, -1.7), (1.0, -1.7)])],
                    mass=np.inf, inertia=np.inf, is_area=True)],
        dict(dt=0.01, gravity=(0.0, 0.0)),
        (1.3, 2.0, 0.0, 0.0),
        ((0.3, 0.1), (0.0, 0.15), (0.1, 0.0)),
    ),
}


def kinds_world(name, device="cuda", **config):
    """A world of :data:`KIND_WORLDS` in the port: ``(world, state)``, its
    WorldConfig updated by ``config`` (``use_cuda_solver=True`` runs the
    split step's solver kernel on the card)."""
    from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
    from parallax_tpu_torch.geometry.shapes import box, circle, polygon

    bodies, cfg, *_ = KIND_WORLDS[name]
    return World.build(bodies(BodyDef, box, circle, polygon), WorldConfig(**cfg, **config),
                       device=device)


def kinds_state(name, world, state, B, seed=0, pile=True):
    """``B`` copies of the world's ``[n, ...]`` state, every movable body
    perturbed by numpy-seeded normal noise at the scales of
    :data:`KIND_WORLDS`; with ``pile``, in every odd world the movable
    bodies sit at its pile instead, their positions perturbed at a tenth of
    the scale.  Returns an ``_SoA``."""
    rng = np.random.default_rng(seed)
    n, dev = world.n_bodies, world.device
    _, _, (sp, sv, sa, sw), layout = KIND_WORLDS[name]
    mov = ~np.asarray(world.static_bodies)[:, None]
    noise = rng.standard_normal((6, n, B)).astype(np.float32)
    base = np.stack([state.pos[:, 0].cpu().numpy(), state.pos[:, 1].cpu().numpy(),
                     state.vel[:, 0].cpu().numpy(), state.vel[:, 1].cpu().numpy(),
                     state.angle.cpu().numpy(), state.omega.cpu().numpy()])
    base = np.repeat(base[:, :, None], B, axis=2)
    if pile:
        base[:2, :len(layout), 1::2] = np.float32(layout).T[:, :, None]
        noise[:2, :, 1::2] *= np.float32(0.1)

    def t(k, scale):
        x = base[k] + np.where(mov, noise[k] * np.float32(scale), 0.0)
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

    return tb._SoA(px=t(0, sp), py=t(1, sp), vx=t(2, sv), vy=t(3, sv), angle=t(4, sa),
                   omega=t(5, sw))


def pair_world(kind, device="cpu", **config):
    """A one-pair world at B=1, its two bodies 0.05 deep in each other:
    ``"bb"`` a box crate on a static box, ``"cp"`` a circle on a static
    polygon (a kind no fused kernel runs, in the JAX package either).
    ``config`` goes to ``WorldConfig``.  Returns ``(world, s)``."""
    from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
    from parallax_tpu_torch.geometry.shapes import box, circle, polygon

    crate = (BodyDef(shapes=[box((-0.3, -0.3), (0.3, 0.3))], position=(0.0, -0.25)) if kind == "bb"
             else BodyDef(shapes=[circle(0.3)], position=(0.0, -0.25)))
    ground = (box((-1.0, -0.1), (1.0, 0.0)) if kind == "bb"
              else polygon([(-1.0, -0.1), (1.0, -0.1), (1.0, 0.0), (-1.0, 0.0)]))
    bodies = [crate, BodyDef(shapes=[ground], mass=np.inf, inertia=np.inf, position=(0.0, -0.5))]
    world, st = World.build(bodies, WorldConfig(**config), device=device)
    assert [g.kernel for g in world.table.groups] == [kind]
    return world, tb._to_soa(type(st)(*(x[None] for x in st)))


# the slab the override world's crates rest on: a convex octagon, top at y=0
_SLAB = np.float32([(-4.0, -1.0), (4.0, -1.0), (4.2, -0.5), (4.0, 0.0), (2.0, 0.02),
                    (-2.0, 0.02), (-4.0, 0.0), (-4.2, -0.5)])
_OVR_CRATES = ((-1.5, 0.32), (0.0, 0.32), (1.5, 0.32))  # centres at rest


def override_world(device="cpu", fused=True, posts=32):
    """A lander-style world whose overridden part sits at part index
    ``posts`` (32 by default, past a 32-bit mask): one static body of
    ``posts`` small square polygon posts far below the scene, then the
    static slab (an 8-vertex polygon, the part a caller overrides with
    per-world vertices, as the lander's terrain), then three dynamic
    polygon crates (half-width 0.3) side by side on the slab, so that each
    body's touching lanes are its B side's (its sums take one order in the
    kernel and in the plain version's ``index_add_``).  Broadphase off: every crate meets every post, the slab and the
    other crates as a ``pp`` pair (C=2 x (3 x 33 + 3) = 204 lanes).
    Returns ``(world, slab part index)``."""
    from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
    from parallax_tpu_torch.geometry.shapes import polygon

    sq = [(-0.1, -0.1), (0.1, -0.1), (0.1, 0.1), (-0.1, 0.1)]
    wall = dict(mass=np.inf, inertia=np.inf, friction=0.6, elasticity=0.1)
    bodies = [BodyDef(shapes=[polygon([(x + 0.5 * k, y - 30.0) for x, y in sq])
                              for k in range(posts)], **wall),
              BodyDef(shapes=[polygon(_SLAB)], **wall)]
    crate = [(-0.3, -0.3), (0.3, -0.3), (0.3, 0.3), (-0.3, 0.3)]
    for pos in _OVR_CRATES:
        bodies.append(BodyDef(shapes=[polygon(crate)], mass=1.0, inertia=0.06,
                              position=pos, friction=0.6, elasticity=0.1))
    cfg = WorldConfig(dt=0.01, gravity=(0.0, -9.8), broadphase=False,
                      solver_iterations=6, position_iterations=2,
                      use_cuda_solver=not fused, use_cuda_fused=fused)
    world, _ = World.build(bodies, cfg, device=device)
    return world, posts


def override_state(world, slab, B, seed=0):
    """``B`` worlds of :func:`override_world`: the crates level, their
    centres at their rest places lowered by 0.02-0.03 (every crate
    overlaps the slab that far) and falling at 0.3-0.5, numpy-seeded, with
    no sideways or angular velocity: every lane carries a normal impulse
    well clear of 0 and no friction, so that no lane sits at a kink of the
    solve (a clamp or a max switching its branch), where two float32 VJPs
    differ by O(1) (``chip_smoke.py`` holds the reverse passes here at
    B=1024); and the slab's
    per-world override planes, its local vertices moved by up to 0.01 in y
    (the override dict ``{slab: ([8, B] x, [8, B] y)}``).  Returns ``(s,
    override)``."""
    rng = np.random.default_rng(seed)
    n, dev = world.n_bodies, world.device
    mov = ~np.asarray(world.static_bodies)
    x, y, vx, vy, a, w = (np.zeros((n, B), np.float32) for _ in range(6))
    for i, (cx, cy) in enumerate(_OVR_CRATES):
        k = n - len(_OVR_CRATES) + i
        x[k] = cx + rng.uniform(-0.01, 0.01, B)
        y[k] = cy - 0.02 - 0.005 * i + rng.uniform(-0.003, 0.003, B)
        vy[k] = rng.uniform(-0.5, -0.3, B)
    assert mov.sum() == len(_OVR_CRATES)
    tx = np.repeat(_SLAB[:, 0:1], B, 1)
    ty = _SLAB[:, 1:2] + rng.uniform(-0.01, 0.01, (len(_SLAB), B))

    def t(v):
        return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)

    s = tb._SoA(px=t(x), py=t(y), vx=t(vx), vy=t(vy), angle=t(a), omega=t(w))
    return s, {slab: (t(tx), t(ty))}


def lander_touch_state(env, B, seed=0):
    """``B`` per-world lander states (``BodyState``, ``[B, n, ...]``, for
    ``World.detect_contacts``) on the world's own terrain: the spawn pose
    lowered 13.4-13.9 onto the ground squares (top at y=-9), shifted up to
    0.5 sideways and tilted up to 0.3 rad, numpy-seeded, so that legs and
    hull overlap the ground in most worlds, by 0.0-0.4."""
    from parallax_tpu_torch.dynamics.bodies import BodyState

    rng = np.random.default_rng(seed)
    ib = env._init_bodies
    n = ib.pos.shape[0]
    mov = ~np.asarray(env.world.static_bodies)
    shift = np.stack([rng.uniform(-0.5, 0.5, B), rng.uniform(-13.9, -13.4, B)], -1)
    pos = ib.pos.cpu().numpy()[None] + np.where(mov[None, :, None], shift[:, None, :], 0.0)
    angle = ib.angle.cpu().numpy()[None] + np.where(mov[None], rng.uniform(-0.3, 0.3, (B, n)), 0.0)
    zero = np.zeros((B, n, 2), np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(env.world.device)

    return BodyState(pos=t(pos), vel=t(zero), angle=t(angle), omega=t(zero[..., 0]))


def matrix_bodies(BodyDef, box, circle, polygon):
    """The config matrix's world (``tests/test_config_matrix.py:_world``),
    in either package's types: a tilted square, a triangle, two circles
    and a static ground box; its pair groups are cc, cb, cp, bp and pp."""
    square = polygon([(-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)])
    tri = polygon([(-0.4, -0.3), (0.5, -0.2), (0.0, 0.5)])
    return [
        BodyDef(shapes=[square], mass=1.0, inertia=0.2, position=(0.0, 0.4),
                angle=0.15, elasticity=0.3, friction=0.5),
        BodyDef(shapes=[tri], mass=1.5, inertia=0.3, position=(0.3, 1.1),
                angle=-0.2, elasticity=0.2, friction=0.4),
        BodyDef(shapes=[circle(0.3)], mass=0.8, inertia=0.05,
                position=(-0.45, 0.9), elasticity=0.6, friction=0.3),
        BodyDef(shapes=[circle(0.25)], mass=0.5, inertia=0.04,
                position=(-0.35, 1.4), elasticity=0.9, friction=0.2),
        BodyDef(shapes=[box((-6.0, -2.0), (6.0, 0.0))], mass=np.inf,
                inertia=np.inf, elasticity=0.1, friction=0.6),
    ]


def matrix_config(narrowphase, solver_mode):
    """The config matrix's ``WorldConfig`` fields."""
    return dict(dt=0.01, gravity=(0.0, -9.8), integrator="symplectic",
                narrowphase=narrowphase, solver_mode=solver_mode, solver_iterations=4,
                position_iterations=2 if solver_mode == "block" else 0)


def matrix_world(narrowphase="sat", solver_mode="block", device="cpu"):
    """The config matrix's world as a port world: ``(world, state)``."""
    from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
    from parallax_tpu_torch.geometry.shapes import box, circle, polygon

    return World.build(matrix_bodies(BodyDef, box, circle, polygon),
                       WorldConfig(**matrix_config(narrowphase, solver_mode)), device=device)


def batch_state(state, B, seed=0, pos=0.05, vel=0.2):
    """``B`` copies of a world's ``BodyState`` with numpy-seeded normal
    noise on positions (``pos``) and velocities (``vel``), as the config
    matrix perturbs its batch: a ``BodyState`` ``[B, n, ...]`` on the
    state's device."""
    rng = np.random.default_rng(seed)
    dev = state.pos.device

    def noise(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    b = type(state)(*(x[None].expand((B,) + x.shape).clone() for x in state))
    return b._replace(pos=b.pos + noise(b.pos.shape, pos), vel=b.vel + noise(b.vel.shape, vel))


def world_keys(B, seed, device="cpu"):
    """``B`` threefry keys ``[B, 2]`` (uint32 values in int64) from a numpy
    seed."""
    k = np.random.default_rng(seed).integers(0, 2**32, (B, 2), dtype=np.uint32)
    return torch.from_numpy(k.astype(np.int64)).to(device)


# BASELINE configs 1-3 (tests/test_golden_parity.py:40-137): the ground
# polygon, the reference-mode WorldConfig fields and the keyed rollout
GOLDEN_GROUND = [(-20.0, -2.0), (20.0, -2.0), (20.0, 0.0), (-20.0, 0.0)]


def golden_ground(BodyDef, polygon):
    return BodyDef(shapes=[polygon(GOLDEN_GROUND)], mass=np.inf, inertia=np.inf,
                   elasticity=0.5, friction=0.3)


def reference_config(ContactSolverConfig, **kw):
    """The golden configs' reference pipeline: GJK/EPA, the reference
    impulse formulas, the per-body random choice, no broadphase."""
    base = dict(dt=0.01, gravity=(0.0, -0.2), integrator="reference", narrowphase="gjk_epa",
                solver_mode="random_one_per_body", contact=ContactSolverConfig.reference(),
                broadphase=False)
    base.update(kw)
    return base


def stack_bodies(BodyDef, polygon):
    """BASELINE config 3's stack: three unit boxes on the ground."""
    sq = polygon([(-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)])
    return [BodyDef(shapes=[sq], mass=1.0, inertia=0.2, position=(0.02 * i, 0.55 + 1.05 * i),
                    elasticity=0.1, friction=0.6) for i in range(3)] + [golden_ground(BodyDef, polygon)]


def stack_world(device="cpu", **config):
    """Config 3's stack as a port world in the reference pipeline
    (``config`` updates its fields): ``(world, state)``."""
    from parallax_tpu_torch.dynamics.impulses import ContactSolverConfig
    from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
    from parallax_tpu_torch.geometry.shapes import polygon

    return World.build(stack_bodies(BodyDef, polygon),
                       WorldConfig(**reference_config(ContactSolverConfig, **config)), device=device)


def stack_touch_state(world, state, B, seed=0):
    """``B`` copies of config 3's start pose with the boxes sunk 0.07 (into
    each other and the ground: every pair of neighbours touches) and
    numpy-seeded velocities on the boxes (0.1 a component)."""
    st = batch_state(state, B, seed=seed, pos=0.0, vel=0.1)
    mov = (~torch.tensor(world.static_bodies, device=state.pos.device))[:, None]
    sink = torch.tensor([0.0, 0.07], device=state.pos.device)
    return st._replace(pos=st.pos - mov * sink, vel=st.vel * mov)


def golden_rollout(world, state, n_steps, record_every, seeds):
    """``[T, B, n, 6]`` frames (pos, vel, angle, omega) of the golden
    configs' keyed rollout of ``B = len(seeds)`` worlds: world b steps with
    ``split(PRNGKey(seeds[b]), n_steps)``, as ``test_golden_parity.py``'s
    ``_rollout`` does."""
    from parallax_tpu_torch.utils import prng

    roots = torch.tensor([[0, s] for s in seeds], dtype=torch.int64, device=state.pos.device)
    keys = prng.split(roots, n_steps).transpose(0, 1)  # [n_steps, B, 2]
    frames = []
    with torch.no_grad():
        for t in range(n_steps):
            state, _ = world.step(state, key=keys[t])
            if (t + 1) % record_every == 0:
                frames.append(torch.cat([state.pos, state.vel, state.angle[..., None],
                                         state.omega[..., None]], -1))
    return torch.stack(frames).cpu().numpy()


def hold_config3(got, want):
    """Config 3's frames ``[15, 4, 6]`` against the golden's at the bars of
    ``tests/test_numpy_oracle.py:347-358``: the first 4 frames within
    1e-7, positions within 5e-3, velocities and angles within 1e-1, the
    final heights within 1e-3; the top box stays up.  Returns the four
    largest differences."""
    errs = (np.abs(got[:4, :3] - want[:4, :3]).max(), np.abs(got[:, :3, :2] - want[:, :3, :2]).max(),
            np.abs(got[:, :3, 2:] - want[:, :3, 2:]).max(),
            np.abs(got[-1, :3, 1] - want[-1, :3, 1]).max())
    assert np.isfinite(got).all() and got[-1, 2, 1] > 1.8, "config 3: the stack fell"
    for e, bar, what in zip(errs, (1e-7, 5e-3, 1e-1, 1e-3),
                            ("first 4 frames", "positions", "velocities and angles",
                             "final heights")):
        assert e <= bar, f"config 3 {what}: {e} > {bar}"
    return errs


# -- the per-world env API (envs/base.py) --------------------------------------


def golden_env_rollout(env, B, seed, n_steps, action_at):
    """``([n_steps // 10, B, n, 6] frames, [n_steps, B] rewards)`` of golden
    configs 4, 4k and 5's scripted rollout: ``env.step`` (the port of
    ``vmap(env.step)``) from ``env.reset_fn`` of ``split(PRNGKey(seed), B)``,
    the frames (pos, vel, angle, omega) after steps 1, 11, 21, ...
    (``tests/test_golden_parity.py:140-290``)."""
    from parallax_tpu_torch.utils import prng

    dev = env.device
    st = env.reset_fn(prng.split(torch.tensor([0, seed], device=dev), B))
    frames, rewards = [], []
    with torch.no_grad():
        for t in range(n_steps):
            a = action_at(torch.tensor(t, dtype=torch.int32, device=dev))
            st, ts = env.step(st, a.expand(B, -1))
            b = st.bodies
            frames.append(torch.cat([b.pos, b.vel, b.angle[..., None], b.omega[..., None]], -1))
            rewards.append(ts.reward)
    return torch.stack(frames)[::10].cpu().numpy(), torch.stack(rewards).cpu().numpy()


def golden_lander_action(t):
    """Configs 4 and 4k: the main engine ramping down, slight side pulses."""
    return torch.stack([torch.clamp(1.0 - t / 80.0, 0.0, 1.0), 0.3 * torch.sin(t / 7.0)])


def golden_robocup_action(n_robots):
    """Config 5: phase-shifted velocity commands, every robot moving."""

    def action_at(t):
        phase = torch.arange(n_robots, dtype=torch.float32, device=t.device) * 0.7
        vx = 1.2 * torch.sin(t / 9.0 + phase)
        vy = 0.8 * torch.cos(t / 11.0 + phase)
        w = 0.5 * torch.sin(t / 5.0 + phase)
        return torch.stack([vx, vy, w], dim=-1).reshape(-1)

    return action_at


# golden config: (env, solver_mode, B, seed, steps)
GOLDEN_ENV_CASES = {
    "config4": ("lander", "random_one_per_body", 4, 7, 60),
    "config4k": ("lander", "random_one_per_body_keyed", 2, 7, 40),
    "config5": ("robocup", "random_one_per_body", 4, 11, 80),
}


def golden_env_case(name, device="cpu"):
    """Golden config ``name``'s ``(frames, rewards)`` from the port's env in
    reference mode (``narrowphase="gjk_epa"``,
    ``ContactSolverConfig.reference()``, no broadphase) on ``device``."""
    from parallax_tpu_torch.dynamics.impulses import ContactSolverConfig
    from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
    from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig

    kind, mode, B, seed, steps = GOLDEN_ENV_CASES[name]
    ref = dict(narrowphase="gjk_epa", contact=ContactSolverConfig.reference(),
               broadphase=False, solver_mode=mode)
    if kind == "lander":
        env = LunarLander(LanderConfig(**ref), device=device)
        return golden_env_rollout(env, B, seed, steps, golden_lander_action)
    env = RoboCup(RoboCupConfig(**ref), device=device)
    return golden_env_rollout(env, B, seed, steps, golden_robocup_action(env.n_robots))


def hold_golden_env(name, got, golden):
    """Config ``name``'s frames and rewards against the golden's within
    1e-5, finite; config 5 also within the golden's own sanity bounds.
    Returns the largest frame and reward differences."""
    traj, rew = got
    want_t, want_r = golden[f"{name}_traj"], golden[f"{name}_reward"]
    assert traj.shape == want_t.shape and rew.shape == want_r.shape, name
    assert np.isfinite(traj).all() and np.isfinite(rew).all(), f"{name}: not finite"
    errs = float(np.abs(traj - want_t).max()), float(np.abs(rew - want_r).max())
    assert errs[0] <= 1e-5 and errs[1] <= 1e-5, f"{name}: frames {errs[0]}, rewards {errs[1]}"
    if name == "config5":
        ball, robots = traj[:, :, 4, :2], traj[:, :, 5:, :2]
        assert (np.abs(ball[..., 0]) < 5.3).all() and (np.abs(ball[..., 1]) < 3.8).all()
        assert np.abs(ball[-1] - ball[0]).max() > 0.05
        assert np.abs(robots[-1] - robots[0]).max() > 0.1
    return errs


def lander_scene(env, B, seed=0):
    """``reset_fn`` states of the lander (each world its own terrain) in four
    kinds by world index mod 4: 0 sliding on its pad (legs touching, 0.2
    sideways), 1 set down on its pad (it lands and resets), 2 out of bounds
    (it crashes and resets), 3 free flight."""
    k = np.random.default_rng(seed).integers(0, 2**32, (B, 2), dtype=np.uint32)
    st = env.reset_fn(torch.from_numpy(k.astype(np.int64)).to(env.device))
    w = torch.arange(B, device=env.device) % 4
    zero = torch.zeros(B, device=env.device)
    pos, vel = st.bodies.pos.clone(), st.bodies.vel.clone()
    pos[:, :3, 1] -= torch.where(w == 0, 6.25, torch.where(w == 1, 6.2, zero))[:, None]
    pos[:, :3, 0] += torch.where(w == 2, 16.0, zero)[:, None]
    vel[:, :3, 0] += torch.where(w == 0, 0.2, zero)[:, None]
    return st._replace(bodies=st.bodies._replace(pos=pos, vel=vel))


def robocup_scene(env, B, seed=0):
    """``reset_fn`` states of RoboCup in two kinds by world index mod 2: 0
    the ball at x=-4.55 flying into the yellow goal (blue scores in the
    first step, the episode ends and resets), 1 the first blue robot beside
    the first yellow one."""
    k = np.random.default_rng(seed).integers(0, 2**32, (B, 2), dtype=np.uint32)
    st = env.reset_fn(torch.from_numpy(k.astype(np.int64)).to(env.device))
    bi, r0, N = env.ball_idx, int(env.robot_idx[0]), env.config.n_robots_per_team
    pos, vel = st.bodies.pos.clone(), st.bodies.vel.clone()
    goal = torch.arange(B, device=env.device) % 2 == 0
    pos[goal, bi] = torch.tensor([-4.55, 0.0], device=env.device)
    vel[goal, bi] = torch.tensor([-3.0, 0.0], device=env.device)
    pos[~goal, r0] = pos[~goal, r0 + N] + torch.tensor([0.15, 0.0], device=env.device)
    return st._replace(bodies=st.bodies._replace(pos=pos, vel=vel))


def env_actions(env, n, B, seed=0):
    """``[n, B, action_size]`` seeded actions: the lander's main throttle in
    [0, 1] and side in [-1, 1]; RoboCup's commands in [-2, 2]."""
    rng = np.random.default_rng(seed)
    if env.action_size == 2:
        a = np.stack([rng.uniform(0, 1, (n, B)), rng.uniform(-1, 1, (n, B))], -1)
    else:
        a = rng.uniform(-2.0, 2.0, (n, B, env.action_size))
    return torch.from_numpy(a.astype(np.float32)).to(env.device)
