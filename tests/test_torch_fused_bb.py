"""The box-box (``bb``) lane of the fused step, and ``step_batched`` on crate worlds.

The crate pile (``tests/torch_scenarios.py:crate_world``) is a user-built
scene: a floor and two walls, box crates and balls, ``bb``, ``cb`` and
``cc`` pairs, one lane each.  On the CPU the fused step runs its plain
version, the split step with the fused rule for a pair with no valid axis,
and its reverse pass is autograd of it.  Held here:

* ``fused_step_plain`` on a small pile (4 crates, a ball, the floor and
  the walls; B=``TILE_B``, the JAX test's tile) against the JAX package's
  fused kernel in interpret mode, as ``tests/test_pallas_solver.py:519``
  runs it: body planes atol 1e-5, active flags equal, ``bb`` lanes active;
* ``fused_step_bwd_plain`` on a pile of 5 crates and 3 balls (``MID``: cc,
  cb and bb lanes, C=52) against ``jax.vjp`` of the JAX split step (the
  JAX package's reference for its fused reverse kernel): rtol 2e-4, atol
  1e-5, on ``crate_overlap_state`` (every lane kind fires, every contact at
  least 0.01 deep, so no lane sits near a kink that float32 rounding
  crosses) and at ``bb_tie_case`` (the bb lane's exact ties: its contact
  point's min and max, and the nested minimum of its four overlaps), one
  batch for both.  ``test_torch_crate_slice.py`` drives ``step_batched``
  over several steps with the same JAX function.

Inputs come from numpy seeds; each JAX reference is one compile.  The
kernels run only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_scenarios import (N_STATIC, active_kinds, bb_tie_case, cotangents, crate_bodies,
                             crate_config, crate_overlap_state, crate_world)

from parallax_tpu.engine import batched as jb
from parallax_tpu.engine.world import BodyDef, World, WorldConfig
from parallax_tpu.geometry.shapes import box, circle
from parallax_tpu.ops import pallas_solver, pallas_step
from parallax_tpu_torch.engine import batched as tb
from parallax_tpu_torch.ops import fused_step

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 2e-4
SMALL = dict(crates=4, balls=1)
MID, B_MID = dict(crates=5, balls=3), 17


def _jax_world(**counts):
    return World.build(crate_bodies(BodyDef, box, circle, **counts), crate_config(WorldConfig))[0]


def _to_jax(s):
    return jb._SoA(*(jnp.asarray(x.detach().numpy()) for x in s))


def test_fused_plain_matches_jax_fused_kernel():
    world, _ = crate_world("cpu", fused=True, **SMALL)
    jworld = _jax_world(**SMALL)
    assert [g.kernel for g in world.table.groups] == ["cb", "bb"]
    assert fused_step.supports_fused_step(world) and pallas_step.supports_fused_step(jworld)
    B = pallas_solver.TILE_B
    s = crate_overlap_state(world, B, seed=2)
    got_s, got_c = fused_step.physics_core_fused(world, s)
    want_s, want_c = jax.jit(
        lambda s: pallas_step.physics_core_pallas(jworld, s, interpret=True))(_to_jax(s))
    kinds = active_kinds(world, got_c.active)
    assert kinds["bb"] > 0 and kinds["cb"] > 0, kinds
    np.testing.assert_array_equal(got_c.active.numpy(), np.asarray(want_c.active))
    for f, a, b in zip(got_s._fields, got_s, want_s):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0, err_msg=f)


def mid_pile(fused):
    """The ``MID`` pile in both packages, ``B_MID - 1`` worlds of
    ``crate_overlap_state`` and ``bb_tie_case`` as the last, and the JAX
    split step with its VJP, ``(s, c) -> (stepped s, its cotangent)``,
    jitted."""
    world, _ = crate_world("cpu", fused=fused, **MID)
    jworld = _jax_world(**MID)
    s = crate_overlap_state(world, B_MID - 1, seed=0)
    ts, _ = bb_tie_case(world)
    s = tb._SoA(*(torch.cat([a, b], dim=1) for a, b in zip(s, ts)))

    def step_and_vjp(s, c):
        out, vjp = jax.vjp(lambda x: jb.physics_core(jworld, x)[0], s)
        return out, vjp(c)[0]

    return world, s, jax.jit(step_and_vjp)


@pytest.fixture(scope="module")
def pile_vjp():
    """The plain VJP of the fused step on ``mid_pile`` and ``jax.vjp`` of
    the JAX split step, for numpy-seeded cotangents."""
    world, s, step_and_vjp = mid_pile(fused=True)
    cot = cotangents(world.n_bodies, B_MID, 5)
    got = fused_step.fused_step_bwd_plain(world, s, None, cot)[0]
    want = step_and_vjp(_to_jax(s), _to_jax(cot))[1]
    with torch.no_grad():
        active = fused_step.fused_step_plain(world, s)[1].active
    return world, s, got, want, active


@pytest.mark.parametrize("case", ["overlap", "tie"])
def test_fused_bwd_plain_matches_jax_vjp(pile_vjp, case):
    world, s, got, want, active = pile_vjp
    cols = slice(0, B_MID - 1) if case == "overlap" else slice(B_MID - 1, B_MID)
    kinds = active_kinds(world, active[:, cols])
    if case == "overlap":
        assert min(kinds.values()) > 0 and set(kinds) == {"cc", "cb", "bb"}, kinds
    else:
        # the aligned stack and the corner overlap: two bb lanes, nothing else
        assert kinds == {"cc": 0, "cb": 0, "bb": 2}, kinds
        c = N_STATIC
        assert s.px[c, -1] == s.px[c + 1, -1]
        assert s.px[c + 2, -1] == s.py[c + 2, -1] and s.px[c + 4, -1] == s.py[c + 4, -1]
    for f, a, b in zip(s._fields, got, want):
        np.testing.assert_allclose(a[:, cols].numpy(), np.asarray(b)[:, cols], rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    assert all(x[:, cols].abs().max() > 0 for x in got[:4])
