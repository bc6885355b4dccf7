"""Worlds past the 16 parts and 64 bodies the port's kernels once refused.

The JAX package's fused gate (``pallas_step.py:84-93``) has neither
limit, and since the kernels keep a world's state in shared memory sized
by its shapes neither does the port.  On the CPU the wrappers run their
plain versions: billiards with 60 object balls (65 bodies) passes both
gates and its fused plain step equals its split step; the override world
(``tests/torch_scenarios.py:override_world``), whose overridden slab is
part 32, gets its override rank in ``part_i``'s last column and steps
fused as split.  The kernels themselves run these worlds in the g++ host
build (``tests/test_torch_host_forward.py``) and on the card
(``chip_smoke.py`` phase 3).  No jax.
"""

import torch
from torch_scenarios import billiards_pairs_state, override_state, override_world

from parallax_tpu_torch.engine import batched as tb
from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
from parallax_tpu_torch.ops import fused_step


def test_a_world_of_65_bodies_steps_fused_as_split():
    """Billiards61 (61 balls, 65 bodies, C=2074) at B=4 over 3 steps: the
    fused plain step's planes and flags equal the split step's within 1e-6
    (the circle lanes have no SAT axis to lose), and lanes touch."""
    fused = Billiards(BilliardsConfig(n_object=60, use_cuda_fused=True), device="cpu")
    split = Billiards(BilliardsConfig(n_object=60), device="cpu")
    world = fused.world
    assert world.n_bodies == 65 and world.table.n_contacts == 2074
    fused_step.check_fused_step(world)
    a = b = billiards_pairs_state(fused, 4)
    for _ in range(3):
        a, ca = fused_step.physics_core_fused(world, a)
        b, cb = tb.physics_core(split.world, b)
        assert torch.equal(ca.active, cb.active)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
    assert ca.active.sum() > 0


def test_an_override_at_part_32_takes_its_rank_and_steps_fused_as_split():
    """The override world at B=6: the slab is part 32, the one overridden
    part, so its ``part_i`` rank is 0 and every other part's -1; the fused
    plain step over 3 steps, with the slab's per-world vertices, equals the
    split step within 1e-6 and flags alike (every pair has a valid SAT axis
    in these finite worlds), and each crate rests on the slab it was
    given (lanes active in every world)."""
    world, slab = override_world("cpu")
    split, _ = override_world("cpu", fused=False)
    assert slab == 32 and len(world.parts.nverts) == 36
    fused_step.check_fused_step(world)
    part_i = fused_step.fused_operands(world, (slab,)).part_i
    assert part_i[:, 3].tolist() == [0 if p == slab else -1 for p in range(36)]
    assert fused_step.fused_operands(world).part_i[:, 3].eq(-1).all()
    s, override = override_state(world, slab, 6)
    a = b = s
    for _ in range(3):
        a, ca = fused_step.physics_core_fused(world, a, override)
        b, cb = tb.physics_core(split, b, terrain_override=override)
        assert torch.equal(ca.active, cb.active)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=1e-6)
    assert (ca.active.sum(0) >= 3).all()
