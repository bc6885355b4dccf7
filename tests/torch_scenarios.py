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


def mixed_world(device="cpu"):
    """A fused-step world that mixes pair groups: two polygons (one static),
    two circles and a static box, the circles filtered from the polygons
    and the moving polygon from the box.  Its groups are cc, cb and pp, in
    that lane order (1 + 2 + 2 lanes)."""
    from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
    from parallax_tpu_torch.geometry.shapes import box, circle, polygon

    sq = [(-0.3, -0.3), (0.3, -0.3), (0.3, 0.3), (-0.3, 0.3)]
    bodies = [
        BodyDef(shapes=[polygon(sq)], position=(0.0, 1.0)),
        BodyDef(shapes=[polygon([(-2, -0.5), (2, -0.5), (2, 0.5), (-2, 0.5)])],
                mass=np.inf, inertia=np.inf, position=(0.0, 0.3)),
        BodyDef(shapes=[circle(0.2)], position=(3.0, 0.0)),
        BodyDef(shapes=[circle(0.2)], position=(3.3, 0.0)),
        BodyDef(shapes=[box((2.0, -0.5), (5.0, -0.2))], mass=np.inf, inertia=np.inf),
    ]
    return World.build(bodies, WorldConfig(broadphase=False, use_cuda_fused=True),
                       collision_filter=[(0, 2), (0, 3), (1, 2), (1, 3), (0, 4)],
                       device=device)


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


def billiards_pairs_state(env, B, seed=3):
    """Billiards worlds where each ball touches one other ball or a cushion,
    no more: the layout above with numpy-seeded jitter (0.003), every ball
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
    x, y = s.px.cpu().numpy(), s.py.cpu().numpy()
    x[:n] = _PAIRS[:n, 0:1] + rng.uniform(-0.003, 0.003, (n, B))
    y[:n] = _PAIRS[:n, 1:2] + rng.uniform(-0.003, 0.003, (n, B))
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
