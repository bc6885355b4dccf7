"""The random draws and the random solvers against ``jax.random`` and the
JAX package's.

``utils/prng.py``'s ``bernoulli``, ``gumbel``, ``categorical`` and
``choice`` are jax 0.9's draws in its default "low" mode, on 64 numpy-made
keys: ``bernoulli`` and ``choice`` (its float32 cumulative sum and binary
search) to the bit, ``categorical`` index for index, ``gumbel`` within 2
ulps of ``max(|g|, 1)`` (both sides' ``log`` is off by up to an ulp, and
near ``-log(u) = 1`` the outer ``log`` turns an ulp of 1 into that much
absolute error).  Then the policies that consume them: the per-body random
choice of ``solver_mode="random_one_per_body"`` on the config matrix's
contacts, and the keyed replay of the reference collider
(``engine/ref_replay.py``: its plan, its key tree, its resolve) on the
lander's world and BASELINE config 3's stack; the config matrix's world,
whose triangle meets its square as ``('Polygon', 'Polygon4')``, is refused
by both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_scenarios import (batch_state, lander_touch_state, matrix_bodies, matrix_world,
                             reference_config, stack_bodies, stack_touch_state, stack_world,
                             world_keys)

from parallax_tpu.dynamics import solver as jsolver
from parallax_tpu.dynamics.bodies import BodyParams as JParams
from parallax_tpu.dynamics.bodies import BodyState as JState
from parallax_tpu.dynamics.impulses import ContactSolverConfig as JSolverConfig
from parallax_tpu.engine import ref_replay as jreplay
from parallax_tpu.engine.world import BodyDef as JBodyDef
from parallax_tpu.engine.world import World as JWorld
from parallax_tpu.engine.world import WorldConfig as JConfig
from parallax_tpu.envs.lunar_lander import LanderConfig as JLanderConfig
from parallax_tpu.envs.lunar_lander import LunarLander as JLunarLander
from parallax_tpu.geometry import shapes as js
from parallax_tpu.geometry.contacts import Contact as JContact
from parallax_tpu_torch.dynamics import solver
from parallax_tpu_torch.dynamics.impulses import ContactSolverConfig
from parallax_tpu_torch.engine import ref_replay
from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
from parallax_tpu_torch.utils import prng

torch.set_num_threads(2)
B = 8


@pytest.fixture(scope="module")
def keys():
    k = np.random.default_rng(11).integers(0, 2**32, (64, 2), dtype=np.uint32)
    return jnp.asarray(k), torch.from_numpy(k.astype(np.int64))


def _jkeys(t):
    return jnp.asarray(t.numpy().astype(np.uint32))


def test_jax_gumbel_mode_is_the_ported_one():
    """The draws follow jax's "low" mode, which the repo's config keeps."""
    assert not jax.config.jax_high_dynamic_range_gumbel


def test_draws_match_jax(keys):
    """``bernoulli`` and ``choice`` to the bit (``choice`` on rows of
    0-or-1/count probabilities, as the keyed replay draws, empty rows
    included), ``categorical`` index for index on 0/-inf logits, ``gumbel``
    within 2 ulps of max(|g|, 1)."""
    kj, kt = keys
    want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, jnp.float32(0.5)))(kj))
    assert np.array_equal(prng.bernoulli(kt, 0.5).numpy(), want) and 0 < want.mean() < 1
    want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, jnp.float32(0.5), (3, 5)))(kj))
    assert np.array_equal(prng.bernoulli(kt, 0.5, (3, 5)).numpy(), want)

    g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (16,)))(kj))
    gt = prng.gumbel(kt, (16,)).numpy()
    scale = np.spacing(np.maximum(np.abs(g), 1).astype(np.float32))
    assert (np.abs(gt - g) <= 2 * scale).all()

    rng = np.random.default_rng(12)
    mask = rng.random((64, 16)) < 0.4
    logits = np.where(mask, 0.0, -np.inf).astype(np.float32)
    want = np.asarray(jax.vmap(jax.random.categorical)(kj, jnp.asarray(logits)))
    assert np.array_equal(prng.categorical(kt, torch.from_numpy(logits)).numpy(), want)

    for n in (4, 10, 16):
        good = rng.random((64, n)) < 0.5
        cnt = good.sum(-1, keepdims=True).astype(np.float32)
        with np.errstate(invalid="ignore"):
            p = (good.astype(np.float32) / cnt).astype(np.float32)
        want = np.asarray(jax.vmap(lambda k, q: jax.random.choice(k, jnp.arange(n), p=q))(
            kj, jnp.asarray(p)))
        assert (cnt == 0).any() or n > 4
        np.testing.assert_array_equal(prng.choice(kt, torch.from_numpy(p)).numpy(), want)


def test_random_one_per_body_matches_jax():
    """``_resolve_random_one_per_body`` on the config matrix's contacts
    (SAT, B=8 perturbed worlds) with per-world keys, against JAX's under
    ``jax.vmap``: the chosen lanes equal (no flip), velocities within 1e-5,
    under the default and the reference impulse configs."""
    world, st0 = matrix_world("sat", "random_one_per_body")
    st = batch_state(st0, B, seed=21)
    con = world.detect_contacts(st)
    assert con.active.sum() > B
    key = world_keys(B, 22)
    tab = world.table
    args = (np.asarray(tab.body_a), np.asarray(tab.body_b))
    choice, _ = solver.choose_lanes(con, *args, world.n_bodies, key)

    n, C = world.n_bodies, tab.n_contacts
    mem = np.zeros((n, C), bool)
    mem[args[0], np.arange(C)] = mem[args[1], np.arange(C)] = True
    jact = jnp.asarray(con.active.numpy())
    logits = jnp.where(jnp.asarray(mem) & jact[:, None, :], 0.0, -jnp.inf)
    jchoice = jax.vmap(lambda k, lg: jax.vmap(jax.random.categorical)(jax.random.split(k, n), lg))(
        _jkeys(key), logits)
    assert np.array_equal(choice.numpy(), np.asarray(jchoice))

    jst = JState(*(jnp.asarray(x.numpy()) for x in st))
    jcon = JContact(*(jnp.asarray(x.numpy()) for x in (con.penetration, con.point, con.active,
                                                       con.weight)))
    jparams = JParams(*(jnp.asarray(x.numpy()) for x in world.params))
    for kw in (dict(), dict(friction_mode="reference", lever_mode="reference",
                            baumgarte_slop=0.0, baumgarte_max_bias=None)):
        got = solver._resolve_random_one_per_body(st, world.params, con, *args, key,
                                                  ContactSolverConfig(**kw))
        want = jax.jit(jax.vmap(lambda s, c, k: jsolver._resolve_random_one_per_body(
            s, jparams, c, *args, k, JSolverConfig(**kw))))(jst, jcon, _jkeys(key))
        for f in ("vel", "omega"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=0, atol=1e-5, err_msg=f"{kw} {f}")
        assert (got.vel - st.vel).abs().max() > 0.01


KEYED = dict(narrowphase="gjk_epa", solver_mode="random_one_per_body_keyed", broadphase=False)


@pytest.fixture(scope="module")
def keyed_worlds():
    """``{name: (port world, JAX world, BodyState [B, n, ...])}``: the
    lander's world on its own ground (``lander_touch_state``) and config
    3's stack at its start pose sunk 0.07 into itself and the ground with
    numpy-seeded velocities, B=8, both under the reference impulse
    config."""
    env = LunarLander(LanderConfig(contact=ContactSolverConfig.reference(), **KEYED), device="cpu")
    jenv = JLunarLander(JLanderConfig(contact=JSolverConfig.reference(), **KEYED))
    out = {"lander": (env.world, jenv.world, lander_touch_state(env, B))}
    world, st0 = stack_world("cpu", solver_mode=KEYED["solver_mode"])
    jworld, _ = JWorld.build(stack_bodies(JBodyDef, js.polygon),
                             JConfig(**reference_config(JSolverConfig, **KEYED)))
    out["stack"] = (world, jworld, stack_touch_state(world, st0, B, seed=31))
    return out


def _plan_tuple(plan):
    return plan.n_bodies, tuple((b.key_types, b.side0, b.side1) for b in plan.buckets)


def _plans(world, jworld):
    p = world.parts
    return (ref_replay.build_replay_plan(p.kind, p.nverts, p.body, world.n_bodies),
            jreplay.build_replay_plan(jworld.parts.kind, jworld.parts.nverts, jworld.parts.body,
                                      jworld.n_bodies))


def test_replay_plan_matches_jax(keyed_worlds):
    """The host-side bucketing equals JAX's ``build_replay_plan`` as tuples
    on both worlds; the config matrix's world (a triangle against a
    square: ``('Polygon', 'Polygon4')``, outside the reference's dispatch
    table) is refused with ``ValueError`` by both, and so is its
    ``World.step`` in the keyed mode."""
    for world, jworld, _ in keyed_worlds.values():
        plan, jplan = _plans(world, jworld)
        assert _plan_tuple(plan) == _plan_tuple(jplan)
    world, st0 = matrix_world("gjk_epa", "random_one_per_body_keyed")
    p = world.parts
    with pytest.raises(ValueError, match="illegal shape pair"):
        ref_replay.build_replay_plan(p.kind, p.nverts, p.body, world.n_bodies)
    with pytest.raises(ValueError, match="illegal shape pair"):
        world.step(batch_state(st0, 2))
    jworld, _ = JWorld.build(matrix_bodies(JBodyDef, js.box, js.circle, js.polygon))
    jp = jworld.parts
    with pytest.raises(ValueError, match="illegal shape pair"):
        jreplay.build_replay_plan(jp.kind, jp.nverts, jp.body, jworld.n_bodies)


def test_replay_key_schedule_bit_equal(keyed_worlds):
    """The whole key tree, per world, equals JAX's ``replay_key_schedule``
    under ``jax.vmap`` to the bit, on both worlds."""
    key = world_keys(B, 41)
    for world, jworld, _ in keyed_worlds.values():
        plan, jplan = _plans(world, jworld)
        bern, choice = ref_replay.replay_key_schedule(key, plan)
        jbern, jchoice = jax.vmap(lambda k: jreplay.replay_key_schedule(k, jplan))(_jkeys(key))
        assert len(bern) == len(jbern)
        for g, w in zip(bern, jbern):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))
        np.testing.assert_array_equal(choice.numpy(), np.asarray(jchoice).astype(np.int64))


def test_resolve_reference_keyed_matches_jax(keyed_worlds):
    """``resolve_reference_keyed`` with per-world keys on config 3's stack
    against JAX's under ``jax.vmap``: velocities within 1e-5, positions
    untouched; the resolve moves the bodies.  (The lander's world is
    ``tests/test_torch_keyed_lander.py``'s: its JAX reference is a 35 s
    compile.)"""
    hold_keyed(*keyed_worlds["stack"], world_keys(B, 51), "stack")


def hold_keyed(world, jworld, st, key, name):
    """The port's keyed resolve against JAX's on ``st`` with ``key``."""
    plan, jplan = _plans(world, jworld)
    got = ref_replay.resolve_reference_keyed(world.world_parts(st), st, world.params, plan, key,
                                             world.config.contact)
    jst = JState(*(jnp.asarray(x.numpy()) for x in st))
    want = jax.jit(jax.vmap(lambda s, k: jreplay.resolve_reference_keyed(
        jworld.world_parts(s), s, jworld.params, jplan, k, jworld.config.contact)))(
        jst, _jkeys(key))
    for f in ("vel", "omega"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-5, err_msg=f"{name} {f}")
    assert torch.equal(got.pos, st.pos)
    assert (got.vel - st.vel).abs().max() > 0.01, name
