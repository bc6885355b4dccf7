"""The gradient of ``World.step`` against ``jax.grad``, and a JAX world's
leaves and states carried into the port (``utils/convert.py``).

The gradient (the model is ``tests/test_world.py:217``): a scalar of the
state after three block-solver steps of balls pressed into the ground
(``narrowphase="sat"``), wrt the initial velocities and the body
parameters, at rtol 2e-4, atol 1e-5, on contacts at least 0.01 deep
(clear of the solve's kinks).  The carried world: the config matrix's
with every body parameter and part perturbed in JAX, stepped by both
packages at the bars of ``tests/test_torch_world_step.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_world_step import hold_step, held_worlds, jax_world
from torch_scenarios import batch_state, matrix_world

from parallax_tpu.dynamics.bodies import BodyParams as JParams
from parallax_tpu.dynamics.bodies import BodyState as JState
from parallax_tpu.engine.world import BodyDef as JBodyDef
from parallax_tpu.engine.world import World as JWorld
from parallax_tpu.engine.world import WorldConfig as JConfig
from parallax_tpu.geometry import shapes as js
from parallax_tpu_torch.dynamics.bodies import BodyParams, BodyState
from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
from parallax_tpu_torch.geometry import shapes as tsh
from parallax_tpu_torch.utils import convert

torch.set_num_threads(2)
B = 8


def _balls(BodyDef, box, circle):
    """Three balls (one a polygon) pressed into a static ground box."""
    return [
        BodyDef(shapes=[circle(0.3)], mass=1.0, inertia=0.05, position=(-1.0, 0.28),
                elasticity=0.5, friction=0.4),
        BodyDef(shapes=[circle(0.2)], mass=0.7, inertia=0.02, position=(0.0, 0.18),
                elasticity=0.8, friction=0.2),
        BodyDef(shapes=[circle(0.25)], mass=0.9, inertia=0.03, position=(1.0, 0.23),
                elasticity=0.3, friction=0.6),
        BodyDef(shapes=[box((-4.0, -1.0), (4.0, 0.0))], mass=np.inf, inertia=np.inf,
                elasticity=0.4, friction=0.5),
    ]


def test_gradient_of_three_steps_matches_jax_grad():
    """d(sum of the balls' heights and x-velocities after 3 steps) wrt the
    initial velocities and the body parameters (mass, inertia, elasticity,
    friction), B=4 worlds of balls moving into the ground (every contact
    0.01 deep or more), under the block solver (2 velocity and 1 position
    iterations: JAX's gradient of the default 4 and 2 is a 16 s compile):
    against ``jax.grad`` of JAX's vmapped steps at rtol 2e-4, atol 1e-5."""
    cfg = dict(dt=0.01, gravity=(0.0, -9.8), integrator="symplectic", solver_iterations=2,
               position_iterations=1)
    world, st0 = World.build(_balls(BodyDef, tsh.box, tsh.circle), WorldConfig(**cfg),
                             device="cpu")
    jworld, _ = JWorld.build(_balls(JBodyDef, js.box, js.circle), JConfig(**cfg))
    rng = np.random.default_rng(6)
    vel0 = np.zeros((4, 4, 2), np.float32)
    vel0[:, :3] = np.stack([rng.uniform(-0.5, 0.5, (4, 3)), rng.uniform(-1.0, -0.3, (4, 3))], -1)
    pos0 = np.broadcast_to(st0.pos.numpy(), (4, 4, 2)).copy()
    zeros = np.zeros((4, 4), np.float32)

    def port_loss(vel, params):
        w = dataclasses.replace(world, params=params)
        s = BodyState(torch.from_numpy(pos0), vel, torch.from_numpy(zeros), torch.from_numpy(zeros))
        for _ in range(3):
            s, con = w.step(s)
            # every ball presses on the ground, 0.01 deep or more; no ball
            # touches another
            depth = con.penetration.norm(dim=-1)[con.active]
            assert con.active.sum() == 12 and depth.min() >= 0.01, depth
        return s.pos[:, :3, 1].sum() + s.vel[:, :3, 0].sum()

    vel = torch.from_numpy(vel0).requires_grad_()
    params = BodyParams(*(x.clone().requires_grad_() for x in world.params))
    got = torch.autograd.grad(port_loss(vel, params), [vel, *params])

    def jax_loss(vel, params):
        w = jworld.replace(params=params)

        def run(p, v):
            s = JState(p, v, jnp.zeros(4), jnp.zeros(4))
            s = jax.lax.fori_loop(0, 3, lambda _, s: w.step(s)[0], s)
            return s.pos[:3, 1].sum() + s.vel[:3, 0].sum()

        return jax.vmap(run)(jnp.asarray(pos0), vel).sum()

    jparams = JParams(*(jnp.asarray(x.numpy()) for x in world.params))
    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(jnp.asarray(vel0), jparams)
    want = [want[0], *(getattr(want[1], f) for f in BodyParams._fields)]
    for name, g, w in zip(["vel"] + list(BodyParams._fields), got, want):
        w = np.asarray(w)
        movable = np.isfinite(world.params.mass.numpy())
        g = g.numpy()
        if name != "vel":
            g, w = g[movable], w[movable]
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=1e-5, err_msg=name)
    assert np.abs(got[0].numpy()).max() > 1e-3


def test_world_leaves_and_states_carried_from_jax():
    """``utils/convert.py``: a JAX world's differentiable leaves (the body
    parameters, the part vertices and radii, each perturbed) and a JAX
    ``BodyState`` batch carried into the port as numpy arrays; one block
    step of both at the bars, and the state read back equal."""
    world, st0 = matrix_world("sat", "block")
    jworld = jax_world("sat", "block")
    rng = np.random.default_rng(7)
    jparams = JParams(*(getattr(jworld.params, f) * jnp.asarray(rng.uniform(0.8, 1.2, len(
        world.static_bodies)), jnp.float32) for f in BodyParams._fields))
    jparts = jworld.parts.replace(verts=jworld.parts.verts * 1.05,
                                  radius=jworld.parts.radius * 1.1)
    jworld = jworld.replace(params=jparams, parts=jparts)
    leaves = {f"params.{f}": np.asarray(getattr(jparams, f)) for f in BodyParams._fields}
    leaves.update({"parts.verts": np.asarray(jparts.verts), "parts.radius": np.asarray(jparts.radius)})
    ported = convert.world_leaves_from_numpy(world, leaves)
    assert np.array_equal(ported.parts.verts.numpy(), leaves["parts.verts"])

    jst = JState(*(jnp.asarray(x.numpy()) for x in batch_state(st0, B, seed=8)))
    st = convert.body_state_from_numpy(jst, device="cpu")
    back = convert.body_state_to_numpy(st)
    for f in BodyState._fields:
        assert np.array_equal(back[f], np.asarray(getattr(jst, f)))
    out, con = ported.step(st)
    want, jcon = jax.jit(jax.vmap(lambda s: jworld.step(s)))(jst)
    assert held_worlds(con, jcon).all() and con.active.any()
    hold_step(out, want, slice(None), "carried leaves")
    # the carried leaves matter: the unperturbed world steps elsewhere
    assert (world.step(st)[0].vel - out.vel).abs().max() > 1e-3
