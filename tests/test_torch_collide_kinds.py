"""The batched collide's other pair kinds and ``step_batched`` against the JAX package.

``engine/batched.py`` of the port runs every pair kind of the JAX
package's pair table.  Beside the kinds the envs use (``pp``, ``cc``,
``cb``, ``area_cb``), a world a user builds out of circles, boxes and
polygons brings ``bb``, ``cp``, ``bp`` (a box as a 4-corner polygon) and
the containment kinds ``area_pb``, ``area_bb``, ``area_cp``, ``area_pp``
and ``area_bp``.  This file holds the JAX tests' mixed world
(``tests/test_batched_engine.py:21``: ``pp``, ``cp``, ``bp``, ``cc``,
``cb``); ``test_torch_area_kinds.py`` the area worlds, with this file's
helpers.  The worlds are ``tests/torch_scenarios.py:KIND_WORLDS``, at B=32
with the JAX tests' perturbations in even worlds and a pile in odd ones,
all from numpy seeds.  Tolerances:

* the lanes: pen atol 1e-5 everywhere and pt atol 1e-5 on active lanes
  (the JAX tests' bar; an inactive polygon pair's clip points may take
  another of two tied faces under XLA's fused multiply-adds), active flags
  and weights equal, and every kind active in some world;
* their VJP, cotangents on the active lanes: rtol 2e-4, atol 1e-5 (the JAX
  package's bar between its Pallas backward and ``jax.vjp``);
* ``step_batched`` on the mixed world: pos 1e-5, vel 1e-4 and omega 1e-3,
  the bar of ``tests/test_batched_engine.py:76-82``.

Each JAX reference is one ``jax.jit`` (the lanes and their VJP together),
made once per world in a module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_scenarios import KIND_WORLDS, active_kinds, kinds_state, kinds_world

from parallax_tpu.engine import batched as jb
from parallax_tpu.engine.world import BodyDef, World, WorldConfig
from parallax_tpu.geometry.shapes import box, circle, polygon
from parallax_tpu_torch.engine import batched as tb

torch.set_num_threads(2)

B = 32
ATOL, RTOL = 1e-5, 2e-4


def _lanes(con):
    return con.pen_x, con.pen_y, con.pt_x, con.pt_y


def collide_scene(name):
    """One world of ``KIND_WORLDS`` in both packages at B: the port's lanes
    and the VJP of its lanes wrt ``px``, ``py`` and ``angle`` for
    numpy-seeded cotangents on the active lanes; and the JAX package's
    lanes and ``jax.vjp`` of them, one ``jax.jit`` for both."""
    world, st0 = kinds_world(name, "cpu")
    bodies, cfg, *_ = KIND_WORLDS[name]
    jworld, _ = World.build(bodies(BodyDef, box, circle, polygon), WorldConfig(**cfg))
    assert [(g.kernel, g.part_a, g.part_b) for g in world.table.groups] == [
        (g.kernel, g.part_a, g.part_b) for g in jworld.table.groups]
    s = kinds_state(name, world, st0, B)
    s_in = tb._SoA(*(x.clone().requires_grad_(True) for x in s))
    got = tb.collide_batched(world, s_in)
    rng = np.random.default_rng(7)
    cot = [torch.from_numpy(rng.standard_normal(got.active.shape).astype(np.float32))
           * got.active for _ in range(4)]
    got_vjp = torch.autograd.grad(_lanes(got), [s_in.px, s_in.py, s_in.angle], cot)
    s_j = jb._SoA(*(jnp.asarray(x.numpy()) for x in s))

    def lanes(px, py, angle):
        con = jb.collide_batched(jworld, s_j._replace(px=px, py=py, angle=angle))
        return _lanes(con), (con.active, con.weight)

    def primal_and_vjp(px, py, angle, c):
        out, vjp, aux = jax.vjp(lanes, px, py, angle, has_aux=True)
        return out, aux, vjp(c)

    want, (active, weight), want_vjp = jax.jit(primal_and_vjp)(
        s_j.px, s_j.py, s_j.angle, tuple(jnp.asarray(c.numpy()) for c in cot))
    return dict(world=world, got=got, got_vjp=got_vjp, want=want, active=active,
                weight=weight, want_vjp=want_vjp)


def check_lanes(sc, kinds):
    """The lanes and flags of a :func:`collide_scene` against JAX's, and
    every kind of ``kinds`` active in some world."""
    got = sc["got"]
    act = got.active.numpy()
    np.testing.assert_array_equal(act, np.asarray(sc["active"]))
    np.testing.assert_array_equal(got.weight.detach().numpy(), np.asarray(sc["weight"]))
    found = active_kinds(sc["world"], got.active)
    assert set(found) == kinds and min(found.values()) > 0, found
    for f, a, b in zip(("pen_x", "pen_y", "pt_x", "pt_y"), _lanes(got), sc["want"]):
        a, b = a.detach().numpy(), np.asarray(b)
        if f.startswith("pt"):
            a, b = a[act], b[act]
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0, err_msg=f)


def check_vjp(sc):
    """The VJP of a :func:`collide_scene` against ``jax.vjp``."""
    for f, a, b in zip(("px", "py", "angle"), sc["got_vjp"], sc["want_vjp"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=f)
    assert all(g.abs().max() > 0 for g in sc["got_vjp"])


@pytest.fixture(scope="module")
def mixed():
    return collide_scene("mixed")


def test_collide_matches_jax_on_the_mixed_world(mixed):
    check_lanes(mixed, {"pp", "cp", "bp", "cc", "cb"})


def test_collide_vjp_matches_jax_on_the_mixed_world(mixed):
    check_vjp(mixed)


def test_step_batched_matches_jax_on_the_mixed_world():
    """``step_batched`` from ``[B, n, ...]`` states, the split step with its
    plain solver on the CPU, against the JAX package's ``step_batched``."""
    world, st0 = kinds_world("mixed", "cpu")
    bodies, cfg, *_ = KIND_WORLDS["mixed"]
    jworld, _ = World.build(bodies(BodyDef, box, circle, polygon), WorldConfig(**cfg))
    s = kinds_state("mixed", world, st0, B, seed=1)
    state = tb._from_soa(s)
    got, con = tb.step_batched(world, state)
    jstate = jb._from_soa(jb._SoA(*(jnp.asarray(x.numpy()) for x in s)))
    want, jcon = jax.jit(lambda st: jb.step_batched(jworld, st))(jstate)
    assert tuple(got.pos.shape) == (B, world.n_bodies, 2)
    np.testing.assert_array_equal(con.active.numpy(), np.asarray(jcon.active))
    assert np.abs(got.pos.numpy() - np.asarray(want.pos)).max() < 1e-5
    assert np.abs(got.vel.numpy() - np.asarray(want.vel)).max() < 1e-4
    assert np.abs(got.omega.numpy() - np.asarray(want.omega)).max() < 1e-3
    # the hooks run in the batch-minor frame, before and after the step
    kicked, _ = tb.step_batched(world, state, pre=lambda x: x._replace(vx=x.vx + 1.0),
                                post=lambda x: x._replace(omega=x.omega * 0.0))
    assert torch.equal(kicked.omega, torch.zeros_like(kicked.omega))
    mov = ~torch.tensor(world.static_bodies)
    assert (kicked.pos[:, mov, 0] > got.pos[:, mov, 0]).float().mean() > 0.9
