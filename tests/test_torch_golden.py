"""BASELINE configs 1-3 through the port's ``World.step``, held against the
golden trajectories, with no jax.

``tests/golden/golden_parity.npz`` pins the JAX package's reference-mode
pipeline (``narrowphase="gjk_epa"``, ``ContactSolverConfig.reference()``,
``solver_mode="random_one_per_body"``, no broadphase) on configs 1-3
(``tests/test_golden_parity.py:90-137``).  Here the port's world runs the
same rollouts from the same key stream, ``split(PRNGKey(seed), n_steps)``
made by the port's ``utils/prng.py``, and is held to the golden at the
bars the JAX package holds its independent numpy oracle to
(``tests/test_numpy_oracle.py:113-117, 231, 347-358``).  Config 1 also
runs through that oracle (``tests/ref_oracle_numpy.py``) directly, the
port against it at the same bars.  Config 2's eight worlds differ only in
their approach speeds and keys, so they run as one batch of eight.
"""

import os

import numpy as np
import pytest
import torch

from parallax_tpu_torch.dynamics.bodies import BodyState
from parallax_tpu_torch.dynamics.impulses import ContactSolverConfig
from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
from parallax_tpu_torch.geometry.gjk import DEFAULT_INITIAL_DIRECTION
from parallax_tpu_torch.geometry.shapes import circle, polygon
from tests.ref_oracle_numpy import Body, circle_vs_polygon, f32, order_clockwise, step_world
from torch_scenarios import (GOLDEN_GROUND, golden_ground, golden_rollout, hold_config3,
                             reference_config, stack_world)

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "golden_parity.npz")


def _world(bodies, **config):
    return World.build(bodies, WorldConfig(**reference_config(ContactSolverConfig, **config)),
                       device="cpu")


def _batch(state, B):
    return BodyState(*(x[None].expand((B,) + x.shape).clone() for x in state))


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN_PATH)


@pytest.fixture(scope="module")
def config1():
    ball = BodyDef(shapes=[circle(0.5)], mass=1.0, inertia=0.1, position=(0.0, 1.2),
                   elasticity=0.8, friction=0.1)
    world, state = _world([ball, golden_ground(BodyDef, polygon)])
    return golden_rollout(world, _batch(state, 1), 400, 20, [101])[:, 0]


def test_config1_ball_bounce_matches_golden(golden, config1):
    """Config 1 (400 steps, one ball onto the ground: GJK, 128-step EPA on
    the circle, the reference impulse): the first 13 frames (free fall)
    within 1e-5, every frame within 5e-3, and the ball lands."""
    want = golden["config1"]
    assert config1.shape == want.shape and np.isfinite(config1).all()
    np.testing.assert_allclose(config1[:13, 0], want[:13, 0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(config1[:, 0], want[:, 0], rtol=0, atol=5e-3)
    assert config1[:, 0, 1].min() < 0.52


def test_config1_matches_numpy_oracle(config1):
    """Config 1 through ``tests/ref_oracle_numpy.py`` (pure numpy, no code
    shared with either package; its GJK seed direction is the port's
    constant): the port against it at the same bars."""
    ground_verts = order_clockwise(f32(GOLDEN_GROUND))
    dir0 = np.asarray(DEFAULT_INITIAL_DIRECTION, np.float32)
    bodies = [Body(pos=(0.0, 1.2), vel=(0.0, 0.0), angle=0.0, omega=0.0, mass=1.0,
                   inertia=0.1, elasticity=0.8, friction=0.1),
              Body(pos=(0.0, 0.0), vel=(0.0, 0.0), angle=0.0, omega=0.0, mass=np.inf,
                   inertia=np.inf, elasticity=0.5, friction=0.3)]

    def detect(bodies):
        info = circle_vs_polygon(bodies[0].pos, 0.5, ground_verts, dir0)
        if info.isnan():
            return {}
        return {0: (1, info), 1: (0, info.invert())}

    frames = []
    for step in range(400):
        bodies = step_world(bodies, detect, dt=0.01, gravity=(0.0, -0.2))
        if (step + 1) % 20 == 0:
            frames.append(np.concatenate([bodies[0].pos, bodies[0].vel,
                                          np.float32([bodies[0].angle, bodies[0].omega])]))
    oracle = np.stack(frames)
    np.testing.assert_allclose(config1[:13, 0], oracle[:13], rtol=0, atol=1e-5)
    np.testing.assert_allclose(config1[:, 0], oracle, rtol=0, atol=5e-3)


def test_config2_two_circles_match_golden(golden):
    """Config 2 (two circles collide head on, approach speed 0.5 + 0.1 w in
    world w, keys of seed 200 + w; 200 steps): all eight worlds as one
    batch, every frame within 1e-5, and the circles bounce apart."""
    a = BodyDef(shapes=[circle(0.5)], mass=1.0, inertia=0.1, position=(-1.2, 0.0),
                elasticity=1.0, friction=0.0)
    b = BodyDef(shapes=[circle(0.5)], mass=1.0, inertia=0.1, position=(1.2, 0.0),
                elasticity=1.0, friction=0.0)
    world, state = _world([a, b], gravity=(0.0, 0.0))
    v = torch.tensor([0.5 + 0.1 * w for w in range(8)], dtype=torch.float32)
    st = _batch(state, 8)
    vel = torch.zeros(8, 2, 2)
    vel[:, 0, 0], vel[:, 1, 0] = v, -v
    got = golden_rollout(world, st._replace(vel=vel), 200, 10, [200 + w for w in range(8)])
    got = got.transpose(1, 0, 2, 3)  # [8, T, 2, 6]
    want = golden["config2"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got[:, -1, 0, 2] < 0).all()


def test_config3_polygon_stack_matches_golden(golden):
    """Config 3 (three boxes stacked on the ground, the per-body random
    choice live; 300 steps): the first 4 frames within 1e-7, positions
    within 5e-3, velocities and angles within 1e-1, the final heights
    within 1e-3; the top box stays up."""
    world, state = stack_world("cpu")
    got = golden_rollout(world, _batch(state, 1), 300, 20, [303])[:, 0]
    assert got.shape == golden["config3"].shape
    hold_config3(got, golden["config3"])
