"""The fused step's circle-circle and circle-box lanes (``ops/fused_step.py``).

On the CPU the fused step runs its plain version, the split step, which
is held here against the JAX package's fused kernel (``physics_core_pallas``
in interpret mode) and its split step on billiards' overlap state
(``tests/torch_scenarios.py:overlap_state``, the twin of
``tests/test_pallas_solver.py:458``): the balls piled against the +x
cushion so that ball-ball and ball-cushion lanes fire.  Tolerance: atol
1e-5 on the body planes, the bar the JAX package sets between its fused
kernel and its XLA path; the active flags must be equal.  The kernel's
own layout (each pair's first lane and kind) and its gates are checked
here on the host; the kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_scenarios import mixed_world, overlap_state

from parallax_tpu.engine import batched as jb
from parallax_tpu.envs.billiards import Billiards as JaxBilliards
from parallax_tpu.ops import pallas_step
from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
from parallax_tpu_torch.geometry.shapes import box
from parallax_tpu_torch.ops import fused_step

torch.set_num_threads(2)

B = 128
ATOL = 1e-5


@pytest.fixture(scope="module")
def billiards():
    env = Billiards(BilliardsConfig(use_cuda_fused=True), device="cpu")
    return env, JaxBilliards()


def test_plain_version_matches_jax_fused_kernel_and_split_step(billiards):
    env, jenv = billiards
    s = overlap_state(env, B, 3, 1.0, 0.03, 0.02)
    got_s, got_c = fused_step.fused_step_plain(env.world, s)
    s_j = jb._SoA(*(jnp.asarray(x.numpy()) for x in s))
    want_s, want_c = jax.jit(lambda s: jb.physics_core(jenv.world, s))(s_j)
    kern_s, kern_c = jax.jit(
        lambda s: pallas_step.physics_core_pallas(jenv.world, s, interpret=True))(s_j)
    act = got_c.active.numpy()
    cc = [g.kernel for g in env.world.table.groups].index("cc")
    assert cc == 0 and act[:28].sum() > 100 and act[28:].sum() > 100, "cc and cb lanes fire"
    for want, want_a in ((want_s, want_c.active), (kern_s, kern_c.active)):
        np.testing.assert_array_equal(act, np.asarray(want_a))
        for f in got_s._fields:
            np.testing.assert_allclose(getattr(got_s, f).numpy(), np.asarray(getattr(want, f)),
                                       atol=ATOL, rtol=0, err_msg=f)


def four_sides(s):
    """The overlap state (piled against the +x cushion) with its second
    quarter of worlds mirrored onto the -x cushion and its last two
    reflected across the diagonal (y scaled by HALF_H / HALF_W = 0.5) onto
    the +y and -y cushions.  The cushions sit at the origin, so their rows
    are unchanged."""
    q = s.px.shape[1] // 4

    def cat(*planes):
        return torch.cat([p[:, k * q:(k + 1) * q] for k, p in enumerate(planes)], 1)

    return s._replace(px=cat(s.px, -s.px, s.py, s.py), py=cat(s.py, s.py, 0.5 * s.px, -0.5 * s.px),
                      vx=cat(s.vx, -s.vx, s.vy, s.vy), vy=cat(s.vy, s.vy, s.vx, -s.vx))


def test_plain_version_vjp_matches_jax_through_circle_lanes(billiards):
    """The reverse of the fused step on circle worlds: autograd of the
    plain version against ``jax.vjp`` of the JAX split step on the overlap
    state, seeded cotangents on the six body planes, with the cc and cb
    lanes active.  A quarter of the worlds is piled against each cushion
    (:func:`four_sides`), so that the clip of a ball's centre to a
    cushion's bounds in ``_cb_bm`` takes each of its four bounds.  Both run
    in float64, so the test holds the
    formulas and their tie rules rather than rounding: in float32 the piled
    balls' cotangents (up to about 900) differ from their float64 values by
    up to 2e-2 relative, in the JAX package as in the port.  Tolerance:
    rtol 1e-8, atol 1e-10."""
    env, jenv = billiards
    s = four_sides(overlap_state(env, B, 3, 1.0, 0.03, 0.02))
    n = s.px.shape[0]
    cot = [np.random.default_rng(7 + k).standard_normal((n, B)) for k in range(6)]
    s_in = type(s)(*(x.double().requires_grad_(True) for x in s))
    out, con = fused_step.fused_step_plain(env.world, s_in)
    assert out.px.dtype == torch.float64
    act = con.active.numpy()
    t = env.world.table
    assert act[:28].sum() > 100, "cc lanes fire"
    for wall in range(8, 12):  # every cushion's lanes fire
        assert act[[c for c in range(28, 60) if t.body_b[c] == wall]].sum() > 10, wall
    got = torch.autograd.grad(tuple(out), tuple(s_in), [torch.from_numpy(c) for c in cot])
    with jax.enable_x64(True):
        s_j = jb._SoA(*(jnp.asarray(x.double().numpy()) for x in s))
        _, vjp = jax.vjp(lambda s: jb.physics_core(jenv.world, s)[0], s_j)
        (want,) = jax.jit(vjp)(jb._SoA(*(jnp.asarray(c) for c in cot)))
        want = [np.asarray(w) for w in want]
    for f, g, w in zip(s._fields, got, want):
        assert w.dtype == np.float64 and np.abs(w).max() > 0, f
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8, atol=1e-10, err_msg=f)


def test_lane_offsets_follow_the_pair_table():
    """Each pair's first lane and kind in the kernel's operands, on a world
    that mixes groups: the lanes a pair writes carry that pair's bodies in
    the table, and a polygon pair's two lanes are each other's partners."""
    world, _ = mixed_world()
    t = world.table
    assert [(g.kernel, g.size) for g in t.groups] == [("cc", 1), ("cb", 2), ("pp", 1)]
    ops = fused_step.fused_operands(world)
    rows = ops.pair_i.tolist()
    assert [(r[6], r[7]) for r in rows] == [(0, 1), (1, 2), (2, 2), (3, 0)]
    assert [r[2:4] for r in rows] == [[1, 1], [1, 2], [1, 2], [4, 4]]
    np.testing.assert_array_equal(
        ops.pair_f.numpy(), np.float32([[0.2, 0.2], [0.2, 0.0], [0.2, 0.0], [0.0, 0.0]]))
    for (a, b, *_, lane, kind), g in zip(rows, [g for g in t.groups for _ in g.part_a]):
        for k in range(2 if kind == 0 else 1):
            assert (t.body_a[lane + k], t.body_b[lane + k]) == (
                world.parts.body[a], world.parts.body[b])
        if kind == 0:
            assert (t.partner[lane], t.partner[lane + 1]) == (lane + 1, lane)
        else:
            assert t.partner[lane] == -1
    assert rows[-1][6] + 2 == t.n_contacts == 5
    assert fused_step.supports_fused_step(world)
    fused_step.check_fused_step(world)


def test_gates_follow_jax_and_refuse_autograd_on_circle_lanes(billiards):
    """Billiards keeps its broadphase on (the default): its circle and box
    lanes mask themselves, so the fused step takes it, as JAX's gate does.
    The reverse-pass kernel walks back the cc and cb lanes too, so the gate
    takes it under autograd as well; what it refuses under autograd (and
    without) is a kind neither kernel has lanes for, box-box, naming
    ROADMAP item 8f.  physics_core_fused runs the gate before any launch.
    On CPU tensors the plain version's autograd is the backward and runs."""
    env, jenv = billiards
    assert env.world.config.broadphase and jenv.world.config.broadphase
    assert fused_step.supports_fused_step(env.world)
    assert pallas_step.supports_fused_step(jenv.world)
    fused_step.check_fused_step(env.world)
    bb, _ = World.build(
        [BodyDef(shapes=[box((-0.3, -0.3), (0.3, 0.3))]),
         BodyDef(shapes=[box((-1.0, -0.1), (1.0, 0.0))], mass=np.inf, inertia=np.inf,
                 position=(0.0, -0.5))],
        WorldConfig(broadphase=False), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 8f"):
        fused_step.check_fused_step(bb)
    s = overlap_state(env, 4, 3, 1.0, 0.03, 0.02)
    px = s.px.clone().requires_grad_(True)
    out, _ = fused_step.physics_core_fused(env.world, s._replace(px=px))
    (g,) = torch.autograd.grad(out.vx.sum(), px)
    assert torch.isfinite(g).all() and g.abs().max() > 0


def test_a_world_over_the_part_limit_raises():
    """Billiards with 47 object balls has 52 parts, over the kernel's 16:
    the gate raises, where the JAX package quietly takes its split step."""
    world = Billiards(BilliardsConfig(n_object=47, use_cuda_fused=True), device="cpu").world
    assert len(world.parts.nverts) == 52 and fused_step.supports_fused_step(world)
    with pytest.raises(ValueError, match="at most 16 parts"):
        fused_step.check_fused_step(world)
    Billiards(BilliardsConfig(n_object=11, use_cuda_fused=True), device="cpu")
    assert len(Billiards(BilliardsConfig(n_object=11), device="cpu").world.parts.nverts) == 16


def test_python_limits_match_the_kernel_sources():
    """The gate's limits are the kernels' own: the constants of
    ``csrc/fused_step.cuh`` and ``csrc/contact_solver.cuh`` equal
    ``MAX_PARTS``, ``MAX_BODIES`` and ``geometry.shapes.MAX_VERTS``; and the
    pair kinds the host writes into ``pair_i`` are ``PairKind``'s, in its
    order."""
    import re
    from pathlib import Path

    from parallax_tpu_torch.geometry.shapes import MAX_VERTS

    csrc = Path(fused_step.__file__).resolve().parents[1] / "csrc"

    def const(header, name):
        (v,) = re.findall(rf"constexpr int {name} = (\d+);", (csrc / header).read_text())
        return int(v)

    assert const("fused_step.cuh", "MAX_PARTS") == fused_step.MAX_PARTS
    assert const("fused_step.cuh", "MAX_V") == MAX_VERTS
    assert const("contact_solver.cuh", "MAX_BODIES") == fused_step.MAX_BODIES
    (enum,) = re.findall(r"enum PairKind \{([^}]*)\}", (csrc / "fused_step.cuh").read_text())
    kinds = {k.strip(): v for v, k in enumerate(enum.split(","))}
    assert kinds == {"K_" + k.upper(): v for k, v in fused_step._KINDS.items()}
