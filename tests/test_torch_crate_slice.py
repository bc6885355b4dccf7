"""``step_batched`` on the crate pile, several steps and their gradient, against JAX.

The slice as a whole on the CPU: ``engine.batched.step_batched`` over
``STEPS`` steps of ``test_torch_fused_bb.py``'s ``MID`` pile (5 crates, 3
balls, the floor and the walls; ``crate_overlap_state`` and
``bb_tie_case`` as the last world), on the split step
(``use_cuda_solver``: its plain version on CPU tensors) and on the fused
step's plain version (``use_cuda_fused``), against the JAX package's split
step, ``physics_core``, which its ``step_batched`` runs between two
transposes:

* the positions after ``STEPS`` steps, atol 1e-4;
* the gradient of the crates' mean height after them wrt the initial
  velocities, the port's through ``SEGMENTS`` segments under
  ``torch.utils.checkpoint`` as the train path runs them, JAX's by
  chaining the step's ``jax.vjp`` back through the steps (``jax.grad``'s
  arithmetic), 1e-4 relative in norm.

The JAX reference is ``test_torch_fused_bb.py:mid_pile``'s one jitted
function, the step with its VJP.  Also held: what ``chip_smoke.py`` takes
``crate_overlap_state`` for on the full pile at B=8192, every lane kind
firing and every active contact at least 0.01 deep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_bb import B_MID, MID, _to_jax, mid_pile
from torch_scenarios import (N_STATIC, active_kinds, crate_height_loss, crate_overlap_state,
                             crate_world)

from parallax_tpu_torch.engine import batched as tb

torch.set_num_threads(2)

STEPS, SEGMENTS = 12, 2


@pytest.fixture(scope="module")
def reference():
    """The MID pile's start, JAX's positions after STEPS steps, and the
    gradient of the crates' mean height wrt the initial velocities."""
    world, s, step_and_vjp = mid_pile(fused=False)
    zero = _to_jax(tb._SoA(*(torch.zeros_like(x) for x in s)))
    states = [_to_jax(s)]
    for _ in range(STEPS):
        states.append(step_and_vjp(states[-1], zero)[0])
    crates = MID["crates"]
    gpy = np.zeros(s.py.shape, np.float32)
    gpy[N_STATIC:N_STATIC + crates] = 1.0 / (crates * B_MID)
    cot = zero._replace(py=jnp.asarray(gpy))
    for st in reversed(states[:-1]):
        cot = step_and_vjp(st, cot)[1]
    final = states[-1]
    return s, np.stack([final.px, final.py], -1), [np.asarray(cot.vx), np.asarray(cot.vy)]


@pytest.mark.parametrize("fused", [False, True])
def test_step_batched_matches_jax_over_steps(reference, fused):
    s, want_pos, want_grads = reference
    world, _ = crate_world("cpu", fused=fused, **MID)
    vx, vy = (x.clone().requires_grad_(True) for x in (s.vx, s.vy))
    loss, final = crate_height_loss(world, s._replace(vx=vx, vy=vy), STEPS, SEGMENTS)
    got = torch.autograd.grad(loss, [vx, vy])
    pos = torch.stack([final.px, final.py], -1).detach().numpy()
    np.testing.assert_allclose(pos, want_pos, atol=1e-4, rtol=0)
    for a, b in zip(got, want_grads):
        rel = np.linalg.norm(a.numpy() - b) / np.linalg.norm(b)
        assert rel <= 1e-4, rel
    assert all(g.abs().max() > 0 for g in got)


def test_crate_overlap_state_fires_every_kind_deep_enough():
    """On the full pile (C=88) at B=8192: each of the 15 touching pairs of
    the layout is active in every world and no other lane is, so every
    kind fires; every active contact is at least 0.01 deep after the
    step's integration."""
    world, _ = crate_world("cpu")
    assert [(g.kernel, g.size) for g in world.table.groups] == [("cc", 3), ("cb", 33),
                                                                ("bb", 52)]
    s, _ = tb.integrate_bm(world, crate_overlap_state(world, 8192))
    con = tb.collide_batched(world, s)
    per_lane = con.active.sum(1)
    assert set(per_lane.tolist()) == {0, 8192} and int((per_lane > 0).sum()) == 15
    assert active_kinds(world, con.active) == {"cc": 8192, "cb": 3 * 8192, "bb": 11 * 8192}
    depth = torch.sqrt(con.pen_x ** 2 + con.pen_y ** 2)[con.active]
    assert depth.min() >= 0.01
