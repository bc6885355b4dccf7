"""The fused step (``ops/fused_step.py``) against the JAX package's fused kernel.

The scenario is ``tests/test_torch_contact_solver.py``'s at B=128 on a
broadphase-off lander (lowered by 6.2 with ``vy -= 0.6``, 40 zero-action
steps), with one world poisoned by a NaN lander velocity: that world's
lander pairs then have no valid SAT axis, the one case where the fused
step's rule (``pallas_step.py:251``: such a pair is inactive) differs from
the split path's.  JAX's ``physics_core_pallas`` runs its kernel in
interpret mode under ``jax.jit``, compiled once for the file.  Tolerance:
atol 1e-5 on the body planes, the bar the JAX package sets between its
fused kernel and its XLA path; the active flags must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_contact_solver import contact_scenario, lowered_start

from parallax_tpu.engine import batched as jb
from parallax_tpu.envs.lunar_lander import LanderConfig as JaxLanderConfig
from parallax_tpu.envs.lunar_lander import LunarLander as JaxLander
from parallax_tpu.ops import pallas_step
from parallax_tpu_torch.engine import batched as tb
from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
from parallax_tpu_torch.ops import contact_solver, fused_step

torch.set_num_threads(2)

B = 128
ATOL = 1e-5
BAD = 5  # the world whose lander velocity is NaN


@pytest.fixture(scope="module")
def fused():
    env = LunarLander(LanderConfig(broadphase=False, use_cuda_fused=True), device="cpu")
    s, _, override = contact_scenario(env, B)
    vx = s.vx.clone()
    vx[0, BAD] = float("nan")
    s = s._replace(vx=vx)
    jenv = JaxLander(JaxLanderConfig(broadphase=False))
    return env, jenv, s, override, fused_step.fused_step_plain(env.world, s, override)


def _lander_lanes(world):
    ba, bb = np.asarray(world.table.body_a), np.asarray(world.table.body_b)
    return np.nonzero((ba == 0) | (bb == 0))[0]


def test_fused_plain_matches_jax_fused_kernel(fused):
    env, jenv, s, override, (got_s, got_c) = fused
    s_j = jb._SoA(*(jnp.asarray(x.numpy()) for x in s))
    ov_j = {p: (jnp.asarray(x.numpy()), jnp.asarray(y.numpy())) for p, (x, y) in override.items()}
    want_s, want_c = jax.jit(
        lambda s: pallas_step.physics_core_pallas(
            jenv.world, s, terrain_override=ov_j, interpret=True
        )
    )(s_j)

    assert int(got_c.active.sum()) > 100, "scenario must have real contacts"
    np.testing.assert_array_equal(got_c.active.numpy(), np.asarray(want_c.active))
    finite = np.arange(B) != BAD
    for f in got_s._fields:
        np.testing.assert_allclose(
            getattr(got_s, f).numpy()[:, finite], np.asarray(getattr(want_s, f))[:, finite],
            atol=ATOL, rtol=0, err_msg=f,
        )
    # the poisoned world's lander pairs: inactive under the fused rule, as
    # in JAX's kernel; the split path flags them active
    lanes = _lander_lanes(env.world)
    assert not got_c.active[lanes, BAD].any()
    split = tb.collide_batched(env.world, tb.integrate_bm(env.world, s)[0], override)
    assert split.active[lanes, BAD].any()
    assert not np.isfinite(got_s.px.numpy()[0, BAD])


@pytest.mark.parametrize("broadphase", [False, True])
def test_supports_fused_step_agrees_with_jax(fused, broadphase):
    env, jenv, *_ = fused
    world = dataclasses.replace(
        env.world, config=dataclasses.replace(env.world.config, broadphase=broadphase)
    )
    jworld = jenv.world.replace(
        config=dataclasses.replace(jenv.world.config, broadphase=broadphase)
    )
    assert fused_step.supports_fused_step(world) is (not broadphase)
    assert pallas_step.supports_fused_step(jworld) is (not broadphase)
    if broadphase:
        with pytest.raises(ValueError, match="broadphase=False"):
            fused_step.check_fused_step(world)
    else:
        fused_step.check_fused_step(world)


def test_lander_refuses_the_fused_step_with_broadphase():
    with pytest.raises(ValueError, match="broadphase=False"):
        LunarLander(LanderConfig(use_cuda_fused=True), device="cpu")


def test_gate_names_the_roadmap_item_for_unported_lanes():
    """The gate runs the JAX fused kernel's five kinds: a box on a static
    box (bb) passes, and its operands carry one bb lane (kind 4, rows lb
    and ub).  A kind the JAX fused kernel lacks too (a circle on a polygon,
    cp) raises, naming the split step, as do its operands; JAX's gate
    refuses it as well and takes its split step quietly."""
    from torch_scenarios import pair_world

    world, _ = pair_world("bb", broadphase=False)
    assert fused_step.supports_fused_step(world)
    fused_step.check_fused_step(world)
    ops = fused_step.fused_operands(world)
    assert ops.pair_i.tolist() == [[0, 1, 2, 2, 3, 3, 0, fused_step._KINDS["bb"]]]
    assert fused_step._lane_count(world) == world.table.n_contacts == 1
    cp, _ = pair_world("cp", broadphase=False)
    assert not fused_step.supports_fused_step(cp)
    with pytest.raises(ValueError, match="split step"):
        fused_step.check_fused_step(cp)
    # nor do the kernel's operands encode lanes it would misread
    with pytest.raises(ValueError, match="split step"):
        fused_step.fused_operands(cp)
    assert fused_step.FUSED_KERNELS == pallas_step.FUSED_KERNELS


def test_fused_operands_match_jax_static_info(fused):
    env, jenv, _, override, _ = fused
    st = pallas_step._static_step_info(jenv.world, tuple(override))
    ops = fused_step.fused_operands(env.world)
    np.testing.assert_array_equal(ops.part_lv.numpy(), st["lv"])
    np.testing.assert_array_equal(ops.part_i[:, 0].numpy(), st["body_of"])

    def bits(mask):
        return sum(1 << v for v, on in enumerate(mask) if on > 0)

    # then each pair's first lane (two a pp pair) and its kind (pp: 0)
    want = [
        (a, b, g["Va"], g["Vb"], bits(g["ema"][j]), bits(g["emb"][j]), 2 * j, 0)
        for g in st["groups"]
        for j, (a, b) in enumerate(zip(g["ia"], g["ib"]))
    ]
    assert [tuple(r) for r in ops.pair_i.tolist()] == want
    assert 2 * len(want) == env.world.table.n_contacts
    assert not ops.pair_f.any()  # polygons have no radius


def test_wrapper_runs_plain_version_on_cpu_without_launching(fused):
    env, _, s, override, (want_s, want_c) = fused
    before = (fused_step.launches, contact_solver.launches)
    got_s, got_c = tb.physics_core(env.world, s, terrain_override=override)
    assert (fused_step.launches, contact_solver.launches) == before == (0, 0)
    assert torch.equal(got_c.active, want_c.active)
    for a, b in zip(got_s, want_s):
        assert ((a == b) | (a.isnan() & b.isnan())).all()
    zero = torch.zeros_like(got_c.pen_x)
    for plane in (got_c.pen_x, got_c.pen_y, got_c.pt_x, got_c.pt_y):
        assert torch.equal(plane, zero)
    assert torch.equal(got_c.weight, torch.ones_like(zero))


def test_fused_rollout_on_cpu_equals_split_rollout(fused):
    env = fused[0]
    split_env = LunarLander(LanderConfig(broadphase=False), device="cpu")
    rng = np.random.default_rng(11)
    W = torch.from_numpy((rng.standard_normal((9, 2)) * 0.5).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(2) * 0.3).astype(np.float32))

    def policy(p, obs):
        return torch.tanh(obs @ p[0] + p[1])

    st = lowered_start(env, 16, seed=4)  # the legs touch down from the start
    got_final, got = env.rollout_batch(st, policy, 20, (W, b))
    want_final, want = split_env.rollout_batch(st, policy, 20, (W, b))
    for f in ("obs", "reward", "terminated", "truncated"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.info["leg_contacts"], want.info["leg_contacts"])
    assert got.info["leg_contacts"].any()
    for a, b_ in zip(got_final.bodies, want_final.bodies):
        assert torch.equal(a, b_)
