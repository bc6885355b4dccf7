"""The area_cb lane (``engine/batched.py:_area_cb_bm``) and RoboCup's fused step.

RoboCup keeps its ball and robots inside the field with circle-in-area-box
(``area_cb``) lanes, beside circle-circle (``cc``) and circle-box (``cb``)
lanes against the goals.  On the CPU the fused step runs its plain
version, the split step; it is held here against the JAX package's split
step (``physics_core``, which ``tests/test_pallas_solver.py:481`` holds
equal to the interpret-mode fused kernel) and its VJP against ``jax.vjp``
of it, which is what the JAX package itself takes as the fused step's
backward for RoboCup (C=70 is no multiple of 8: ``pallas_step.py:660-673``).
The state is ``tests/torch_scenarios.py:robocup_overlap_state``: in each
quarter of the worlds the ball and robots pile near a goal and poke past
one of the field's four sides.  Inputs come from numpy seeds.  Tolerances:

* ``_area_cb_bm`` and ``_cb_bm``: the same float32 operations in both
  frameworks, so values equal and cotangents within 1e-6 relative, at
  exact ties of each of the area lane's four floors and of the circle-box
  lane's clamp (half the cotangent to each side, as ``jnp.maximum`` and
  ``jnp.clip``);
* the step: body planes atol 1e-5 (the bar the JAX package sets between
  its fused kernel and its split step), flags equal;
* the VJP: rtol 2e-4, atol 1e-5 (the JAX package's bar between its
  kernel's backward and ``jax.vjp``), in float32: every contact of the
  overlap state is at least 0.01 deep, so no lane sits near a kink that
  float32 rounding crosses (billiards' pile has such lanes and is held in
  float64, ``test_torch_fused_circle_box.py``).

The kernels run only on the card (``tests/test_torch_cuda.py``).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_scenarios import active_kinds, pair_world, robocup_overlap_state

from parallax_tpu.engine import batched as jb
from parallax_tpu.envs.robocup import RoboCup as JaxRoboCup
from parallax_tpu_torch.engine import batched as tb
from parallax_tpu_torch.envs.robocup import BALL_RADIUS, RoboCup, RoboCupConfig
from parallax_tpu_torch.ops import fused_step

torch.set_num_threads(2)

B = 64
ATOL, RTOL = 1e-5, 2e-4


@pytest.fixture(scope="module")
def robocup():
    env = RoboCup(RoboCupConfig(use_cuda_fused=True), device="cpu")
    return env, JaxRoboCup(), robocup_overlap_state(env, B)


def _lane_vs_jax(t_fn, j_fn, r, ins, g):
    """Values and VJP of a torch lane function against its JAX twin, on
    the same float32 inputs ``(cx, cy, lbx, lby, ubx, uby)`` and radius
    column ``r``, with cotangents ``g`` on pen_x, pen_y, pt_x, pt_y: values
    equal, input cotangents within 1e-6 relative.  Returns the torch
    cotangents and the active flags."""
    t_in = [torch.from_numpy(x.copy()).requires_grad_(True) for x in ins]
    got = t_fn(t_in[0], t_in[1], torch.from_numpy(r), *t_in[2:])
    t_grads = torch.autograd.grad(got[:4], t_in, [torch.from_numpy(x) for x in g])
    j_in = [jnp.asarray(x) for x in ins]

    def f(cx, cy, lbx, lby, ubx, uby):
        return j_fn(cx, cy, jnp.asarray(r), lbx, lby, ubx, uby)[:4]

    want, vjp = jax.vjp(f, *j_in)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(j_fn(*j_in[:2], jnp.asarray(r),
                                                                   *j_in[2:])[4]))
    for a, b in zip(got[:4], want):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    for name, a, b in zip(("cx", "cy", "lbx", "lby", "ubx", "uby"), t_grads,
                          vjp(tuple(jnp.asarray(x) for x in g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=name)
    return t_grads, got[4]


def test_area_cb_and_cb_lanes_match_jax_at_ties():
    """``_area_cb_bm``: rows 0-3 put one floor at an exact tie (the circle
    touches the right, top, left or bottom side) while the next side keeps
    the lane active, so the tie's cotangent is split; rows 4-7 are random.
    ``_cb_bm``: rows 0-3 put the circle's centre exactly on the box's left,
    right, bottom or top side, the ties of its clamp; rows 4-7 are random.
    Values equal, and the VJP of every input against ``jax.vjp``."""
    rng = np.random.default_rng(0)
    G, W = 8, 16
    r = np.full((G, 1), 0.25, np.float32)
    cx = rng.uniform(-0.3, 0.3, (G, W)).astype(np.float32)
    cy = rng.uniform(-0.3, 0.3, (G, W)).astype(np.float32)
    lo, hi = np.full((G, W), -0.5, np.float32), np.full((G, W), 0.5, np.float32)
    g = [rng.standard_normal((G, W)).astype(np.float32) for _ in range(4)]
    # exact ties in float32: 0.25 + 0.25 - 0.5 == 0 and -0.5 - (-0.25 - 0.25) == 0
    ax, ay = cx.copy(), cy.copy()
    ax[0], ay[0] = 0.25, 0.375  # right side tied, top side over by 0.125
    ax[1], ay[1] = 0.375, 0.25  # top tied, right over
    ax[2], ay[2] = -0.25, -0.375  # left tied, bottom over
    ax[3], ay[3] = -0.375, -0.25  # bottom tied, left over
    ax[4:] *= 2.0
    grads, active = _lane_vs_jax(tb._area_cb_bm, jb._area_cb_bm, r, (ax, ay, lo, lo, hi, hi), g)
    assert active[:4].all(), "each tie row's lane is active"
    # the tie halves the cotangent: row 0's pen_x reaches ubx at -1/2 of g
    np.testing.assert_allclose(grads[4][0].numpy(), 0.5 * g[0][0], rtol=1e-6)
    bx, by = cx.copy(), cy.copy()
    bx[0], bx[1], by[2], by[3] = -0.5, 0.5, -0.5, 0.5  # the centre on each side
    bx[4:] *= 3.0
    grads, active = _lane_vs_jax(tb._cb_bm, jb._cb_bm, r, (bx, by, lo, lo, hi, hi), g)
    assert active[:4].all() and not active.all()
    assert (grads[2][0] != 0).all() and (grads[4][1] != 0).all(), "the tie feeds the bound"


def test_fused_plain_matches_jax_physics_core_on_robocup(robocup):
    env, jenv, s = robocup
    got_s, got_c = fused_step.fused_step_plain(env.world, s)
    s_j = jb._SoA(*(jnp.asarray(x.numpy()) for x in s))
    want_s, want_c = jax.jit(lambda s: jb.physics_core(jenv.world, s))(s_j)
    act = got_c.active.numpy()
    np.testing.assert_array_equal(act, np.asarray(want_c.active))
    on = active_kinds(env.world, act)
    assert on["cc"] > 50 and on["cb"] > 50 and on["area_cb"] >= B, on
    for f in got_s._fields:
        np.testing.assert_allclose(getattr(got_s, f).numpy(), np.asarray(getattr(want_s, f)),
                                   atol=ATOL, rtol=0, err_msg=f)


def test_fused_plain_vjp_matches_jax_vjp_on_robocup(robocup):
    """Autograd of the plain fused step against ``jax.vjp`` of the JAX
    split step, seeded cotangents on the six body planes, with cc, cb and
    area_cb lanes active: every input plane within rtol 2e-4, atol 1e-5,
    the static bodies' (field, goals) included."""
    env, jenv, s = robocup
    n = s.px.shape[0]
    cot = [np.random.default_rng(7 + k).standard_normal((n, B)).astype(np.float32)
           for k in range(6)]
    s_in = type(s)(*(x.clone().requires_grad_(True) for x in s))
    out, con = fused_step.fused_step_plain(env.world, s_in)
    on = active_kinds(env.world, con.active.numpy())
    assert min(on.values()) > 0, on
    got = torch.autograd.grad(tuple(out), tuple(s_in), [torch.from_numpy(c) for c in cot])

    def vjp(s, c):
        return jax.vjp(lambda s: jb.physics_core(jenv.world, s)[0], s)[1](c)[0]

    want = jax.jit(vjp)(jb._SoA(*(jnp.asarray(x.numpy()) for x in s)),
                        jb._SoA(*(jnp.asarray(c) for c in cot)))
    for f, g, w in zip(s._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=f)
    # the field and the goals are static; they still take their cotangents
    assert all(np.abs(np.asarray(want.px)[b]).max() > 0 for b in (0, 2, 3))


def test_both_kernels_dispatch_every_kind_by_name():
    """``pair_lanes`` (a pair's lanes, for ``integrate_and_collide``, the
    first phase of the forward and of the reverse pass's recompute) and the
    reverse pass's lane adjoint (``pair_adjoint``) name every kind of
    ``PairKind`` in a case of their own, so no kind runs as another; a kind
    neither names gives no lane and no cotangent.  Both kernels run that
    one first phase, and both launches check the lane count the kinds
    give."""
    csrc = Path(fused_step.__file__).resolve().parents[1] / "csrc"
    head = (csrc / "fused_step.cuh").read_text()
    bwd = (csrc / "fused_step_bwd.cu").read_text()
    (enum,) = re.findall(r"enum PairKind \{([^}]*)\}", head)
    kinds = [k.strip() for k in enum.split(",")]
    assert kinds == ["K_" + k.upper() for k in fused_step._KINDS]
    geometry = head[head.index("__device__ int pair_lanes"):head.index("struct StepSmem")]
    adjoint = bwd[bwd.index("__device__ void pair_adjoint"):bwd.index("__global__")]
    assert "pair_lanes(" in head[head.index("__device__ void integrate_and_collide"):]
    assert "pair_adjoint(" in bwd[bwd.index("__global__"):]
    for src in ((csrc / "fused_step.cu").read_text(), bwd):
        assert "integrate_and_collide(" in src[src.index("__global__"):]
    for k in kinds:
        assert f"case {k}:" in geometry, k
        assert f"case {k}:" in adjoint or f"qi[Q_KIND] == {k}" in adjoint, k
    assert "default:\n      return 0;" in geometry and "default:\n      break;" in adjoint
    for src in ((csrc / "fused_step.cu").read_text(), bwd):
        assert "C != lanes" in src


def test_robocup_operands_and_gates(robocup):
    """RoboCup's fused operands: each area_cb pair carries the contained
    circle's radius and 0 for the area box, one lane each, 70 in all; the
    gate takes RoboCup under autograd and a box-box world, and refuses a
    world with a kind no fused kernel runs, naming the split step."""
    env, _, s = robocup
    world = env.world
    ops = fused_step.fused_operands(world)
    rows = ops.pair_i.numpy()
    area = rows[:, 7] == fused_step._KINDS["area_cb"]
    assert area.sum() == 7 and rows[area, 6].tolist() == list(range(63, 70))
    radii = ops.pair_f.numpy()[area]
    np.testing.assert_array_equal(radii[:, 1], 0.0)
    np.testing.assert_array_equal(radii[0, 0], np.float32(BALL_RADIUS))
    np.testing.assert_array_equal(radii[1:, 0], np.float32(0.09))
    assert fused_step._lane_count(world) == world.table.n_contacts == 70
    assert fused_step.supports_fused_step(world) and world.config.broadphase
    fused_step.check_fused_step(world)
    # a box on a box (bb) passes the gate; a circle on a polygon (cp), a kind
    # the JAX fused kernel lacks too, raises and names the split step
    fused_step.check_fused_step(pair_world("bb", broadphase=False)[0])
    with pytest.raises(ValueError, match="split step"):
        fused_step.check_fused_step(pair_world("cp", broadphase=False)[0])
    # on CPU tensors autograd of the plain version is the backward
    px = s.px[:, :4].clone().requires_grad_(True)
    s4 = type(s)(*(x[:, :4] for x in s))._replace(px=px)
    out, _ = fused_step.physics_core_fused(world, s4)
    (g,) = torch.autograd.grad(out.vx.sum(), px)
    assert torch.isfinite(g).all() and g.abs().max() > 0

