"""``World.step`` under ``narrowphase="sat"`` against the JAX package's
``jax.vmap(world.step)``, the model being ``tests/test_config_matrix.py``.

The config matrix's world (``tests/torch_scenarios.py:matrix_world``: cc,
cb, cp, bp and pp lanes) at B=8 numpy-perturbed worlds with numpy-made
keys, one step of each solver mode: positions within 1e-5, velocities
within 1e-4 (JAX's own bar between its single and vmapped paths).  The
block mode also against the port's batched ``step_batched`` at JAX's bar
(``tests/test_batched_engine.py:76-83``), and every other pair refused by
``step_batched`` with ``ValueError``.  Both integrators with an ``accel``
on top of gravity.  The ``gjk_epa`` half and the gradient are
``tests/test_torch_world_step_gjk.py``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_scenarios import batch_state, matrix_bodies, matrix_config, matrix_world, world_keys

from parallax_tpu.dynamics.bodies import BodyState as JState
from parallax_tpu.engine.world import BodyDef as JBodyDef
from parallax_tpu.engine.world import World as JWorld
from parallax_tpu.engine.world import WorldConfig as JConfig
from parallax_tpu.geometry import shapes as js
from parallax_tpu_torch.engine.batched import step_batched

torch.set_num_threads(2)
B = 8
SOLVER_MODES = ("block", "jacobi", "gauss_seidel", "random_one_per_body")


def jax_world(narrowphase, solver_mode, **kw):
    cfg = dict(matrix_config(narrowphase, solver_mode), **kw)
    return JWorld.build(matrix_bodies(JBodyDef, js.box, js.circle, js.polygon), JConfig(**cfg))[0]


def jax_step(jworld, st, key, accel=None):
    """JAX's ``jax.jit(jax.vmap(world.step))`` on the port's state and keys."""
    jst = JState(*(jnp.asarray(x.numpy()) for x in st))
    jkey = jnp.asarray(key.numpy().astype(np.uint32))
    fn = jax.jit(jax.vmap(lambda s, k: jworld.step(s, key=k, accel=accel)))
    return fn(jst, jkey)


def held_worlds(con, jcon, atol=1e-5):
    """Worlds whose contact buffers agree with JAX's: flags equal, the
    penetrations and points of active lanes within ``atol``."""
    act, jact = con.active.numpy(), np.asarray(jcon.active)
    ok = (act == jact).all(-1)
    for f in ("penetration", "point"):
        d = np.abs(getattr(con, f).numpy() - np.asarray(getattr(jcon, f))).max(-1)
        ok &= np.where(act, d, 0.0).max(-1) <= atol
    return ok


def hold_step(got, want, worlds, what):
    """Positions within 1e-5 and velocities within 1e-4 on ``worlds``
    (angles 1e-5; angular velocities 1e-3, JAX's batched-engine bar: an
    inertia of 0.04 turns an impulse's rounding into ten times more)."""
    for f, bar in (("pos", 1e-5), ("vel", 1e-4), ("angle", 1e-5), ("omega", 1e-3)):
        np.testing.assert_allclose(getattr(got, f).numpy()[worlds],
                                   np.asarray(getattr(want, f))[worlds], rtol=0, atol=bar,
                                   err_msg=f"{what} {f}")
    assert np.isfinite(got.pos.numpy()).all() and np.isfinite(got.vel.numpy()).all()


@pytest.mark.parametrize("solver_mode", SOLVER_MODES)
def test_sat_step_matches_vmapped_jax(solver_mode):
    """One ``World.step`` of B=8 worlds against ``jax.vmap(world.step)``
    with the same keys: the contact buffers equal, then every world at
    the bars; the step moves the bodies."""
    world, st0 = matrix_world("sat", solver_mode)
    st = batch_state(st0, B, seed=1)
    key = world_keys(B, 42)
    out, con = world.step(st, key=key)
    want, jcon = jax_step(jax_world("sat", solver_mode), st, key)
    assert held_worlds(con, jcon).all() and con.active.any()
    hold_step(out, want, slice(None), solver_mode)
    assert (out.vel - st.vel).abs().max() > 0.05


def test_block_step_matches_step_batched_and_others_refuse():
    """``sat`` + ``block``: ``World.step`` equals the batched step at JAX's
    bar (pos 1e-5, vel 1e-4, omega 1e-3); ``step_batched`` refuses every
    other (narrowphase, solver_mode) pair with ``ValueError`` naming
    ``World.step``, as JAX's refuses them naming ``vmap``."""
    world, st0 = matrix_world("sat", "block")
    st = batch_state(st0, B, seed=2)
    got = world.step(st)[0]
    want = step_batched(world, st)[0]
    for f, bar in (("pos", 1e-5), ("vel", 1e-4), ("angle", 1e-5), ("omega", 1e-3)):
        torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0, atol=bar)
    for nph in ("sat", "gjk_epa"):
        for mode in SOLVER_MODES + ("random_one_per_body_keyed",):
            if (nph, mode) == ("sat", "block"):
                continue
            w, s = matrix_world(nph, mode)
            with pytest.raises(ValueError, match="sat|block") as err:
                step_batched(w, batch_state(s, 2))
            assert "World.step" in str(err.value) and "vmap" in str(err.value)


def test_integrators_and_accel_match_jax():
    """Both integrator orders (``reference``: positions, then the kick;
    ``symplectic``: the kick first) with a per-world ``accel`` ``[B, 1, 2]``
    added to gravity and masked to movable bodies, under the Jacobi solve:
    JAX's vmapped step at the bars, and the static ground's velocity (the
    batch's noise, as the config matrix perturbs every body) unchanged."""
    rng = np.random.default_rng(3)
    accel = rng.normal(0.0, 2.0, (B, 1, 2)).astype(np.float32)
    for integ in ("reference", "symplectic"):
        world, st0 = matrix_world("sat", "jacobi")
        world.config = dataclasses.replace(world.config, integrator=integ)
        st = batch_state(st0, B, seed=4)
        key = world_keys(B, 5)
        out, con = world.step(st, key=key, accel=torch.from_numpy(accel))
        jw = jax_world("sat", "jacobi", integrator=integ)
        jst = JState(*(jnp.asarray(x.numpy()) for x in st))
        want, jcon = jax.jit(jax.vmap(lambda s, k, a: jw.step(s, key=k, accel=a)))(
            jst, jnp.asarray(key.numpy().astype(np.uint32)), jnp.asarray(accel))
        assert held_worlds(con, jcon).all()
        hold_step(out, want, slice(None), integ)
        assert torch.equal(out.vel[:, -1], st.vel[:, -1])
