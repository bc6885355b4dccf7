"""``World.step`` under ``narrowphase="gjk_epa"`` against the JAX package's
``jax.vmap(world.step)``.

The config matrix's world (``tests/torch_scenarios.py:matrix_world``) at
B=8 numpy-perturbed worlds with numpy-made keys, one step of each solver
mode, as ``tests/test_torch_world_step.py`` holds the ``sat`` half.  EPA
on a circle can stop a step apart from XLA's (its guards compare values
that ``sqrt`` and ``log1p``, not correctly rounded there, move by an ulp;
``tests/test_torch_narrowphase.py`` bounds that error), and the step's
impulse turns such a contact's 1e-4 into more than the velocity bar: so
the worlds whose contact buffers differ from JAX's beyond 1e-5 are counted
(at most two of the eight) and the others held at pos 1e-5, vel 1e-4.
The gradient is ``tests/test_torch_world_step_grad.py``'s.
"""

import pytest
import torch
from test_torch_world_step import SOLVER_MODES, hold_step, held_worlds, jax_step, jax_world
from torch_scenarios import batch_state, matrix_world, world_keys

torch.set_num_threads(2)
B = 8


@pytest.mark.parametrize("solver_mode", SOLVER_MODES)
def test_gjk_epa_step_matches_vmapped_jax(solver_mode):
    """One ``World.step`` of B=8 worlds against ``jax.vmap(world.step)``
    with the same keys, on the worlds whose contact buffers agree with
    JAX's within 1e-5 (at least six of eight)."""
    world, st0 = matrix_world("gjk_epa", solver_mode)
    st = batch_state(st0, B, seed=1)
    key = world_keys(B, 42)
    out, con = world.step(st, key=key)
    want, jcon = jax_step(jax_world("gjk_epa", solver_mode), st, key)
    held = held_worlds(con, jcon)
    assert held.sum() >= B - 2, held
    hold_step(out, want, held, solver_mode)
    assert con.active.any() and (out.vel - st.vel).abs().max() > 0.05
