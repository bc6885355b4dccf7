"""``World.detect_contacts`` (the per-world collide) against the JAX package's.

The port's ``engine.collider.collide`` runs every pair group's contact
function on world-frame parts with leading batch axes; JAX's runs one
world under ``jax.vmap``.  On the lander's world, the mixed world of
``tests/torch_scenarios.py`` and the JAX tests' mixed, box-area and
hexagon-area worlds (``KIND_WORLDS``: every pair kind of the table), at
B=64 seeded states, under both narrow phases: flags and weights equal,
penetrations and points within 1e-5.  The two narrow phases agree with
each other on which pairs touch, with depths within 0.01 (the rule of
``tests/test_reference_modes.py``), and the per-world SAT collide equals
the batched step's own ``collide_batched``.  The batched step refuses
``narrowphase="gjk_epa"`` with ``ValueError``, as JAX's does.
"""

import jax
import numpy as np
import pytest
import torch
from torch_scenarios import (
    KIND_WORLDS,
    MIXED_FILTER,
    kinds_state,
    lander_touch_state,
    mixed_bodies,
    mixed_state,
)

from parallax_tpu.dynamics.bodies import BodyState as JState
from parallax_tpu.engine.world import BodyDef as JBodyDef
from parallax_tpu.engine.world import World as JWorld
from parallax_tpu.engine.world import WorldConfig as JConfig
from parallax_tpu.envs.lunar_lander import LanderConfig as JLanderConfig
from parallax_tpu.envs.lunar_lander import LunarLander as JLunarLander
from parallax_tpu.geometry import shapes as js
from parallax_tpu_torch.dynamics.bodies import BodyState
from parallax_tpu_torch.engine import batched as tb
from parallax_tpu_torch.engine.world import BodyDef, World, WorldConfig
from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
from parallax_tpu_torch.geometry import shapes as tsh

B = 64
ATOL = 1e-5
NARROW = ("sat", "gjk_epa")


def _worlds(name, narrowphase):
    """``(port world, JAX world, BodyState [B, n, ...])`` of one scene."""
    if name == "lander":
        env = LunarLander(LanderConfig(narrowphase=narrowphase), device="cpu")
        jenv = JLunarLander(JLanderConfig(narrowphase=narrowphase))
        return env.world, jenv.world, lander_touch_state(env, B)
    kw = dict(device="cpu")
    if name == "mixed_world":
        bodies = (mixed_bodies(BodyDef, tsh.box, tsh.circle, tsh.polygon),
                  mixed_bodies(JBodyDef, js.box, js.circle, js.polygon))
        cfg = dict(broadphase=False, narrowphase=narrowphase)
        kw["collision_filter"] = MIXED_FILTER
    else:
        make, cfg, *_ = KIND_WORLDS[name]
        bodies = (make(BodyDef, tsh.box, tsh.circle, tsh.polygon),
                  make(JBodyDef, js.box, js.circle, js.polygon))
        cfg = dict(cfg, narrowphase=narrowphase)
    world, state = World.build(bodies[0], WorldConfig(**cfg), **kw)
    jworld, _ = JWorld.build(bodies[1], JConfig(**cfg),
                             collision_filter=kw.get("collision_filter", ()))
    s = (mixed_state(world, state, B) if name == "mixed_world"
         else kinds_state(name, world, state, B))
    return world, jworld, tb._from_soa(s)


def _jax_contacts(jworld, st):
    js_ = JState(*(np.asarray(x) for x in st))
    return jax.jit(jax.vmap(jworld.detect_contacts))(js_)


@pytest.mark.parametrize("name", ["lander", "mixed_world", "mixed", "box_area", "hex_area"])
def test_detect_contacts_matches_jax(name):
    """Both narrow phases against JAX's ``detect_contacts`` under
    ``jax.vmap`` at B=64; then SAT against GJK/EPA on per-pair activity
    (equal) and depth (within 0.01 on the pairs both find active)."""
    depth = {}
    for narrowphase in NARROW:
        world, jworld, st = _worlds(name, narrowphase)
        got = world.detect_contacts(st)
        want = _jax_contacts(jworld, st)
        ga, wa = got.active.numpy(), np.asarray(want.active)
        assert ga.shape == (B, world.table.n_contacts)
        assert np.array_equal(ga, wa), (narrowphase, int((ga != wa).sum()))
        assert ga.any(), narrowphase
        assert np.array_equal(got.weight.numpy(), np.asarray(want.weight))
        for f in ("penetration", "point"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=0, atol=ATOL, err_msg=f"{narrowphase} {f}")
        d = got.penetration.norm(dim=-1)
        lanes = _pair_lanes(world)
        depth[narrowphase] = (torch.stack([got.active[:, ln].any(-1) for ln in lanes], -1),
                              torch.stack([d[:, ln].amax(-1) for ln in lanes], -1))
    (a_sat, d_sat), (a_ref, d_ref) = depth["sat"], depth["gjk_epa"]
    assert torch.equal(a_sat, a_ref)
    both = a_sat & a_ref
    assert (d_sat - d_ref).abs()[both].max() < 0.01


def _pair_lanes(world):
    """Each table pair's lane indices."""
    out, lane = [], 0
    for g in world.table.groups:
        w = 2 if (g.kernel in ("pp", "bp") and world.config.narrowphase == "sat") else 1
        for _ in range(g.size):
            out.append(list(range(lane, lane + w)))
            lane += w
    return out


def test_sat_collide_equals_collide_batched():
    """The per-world SAT collide and the batched step's own collide
    (``collide_batched``, batch-minor ``[C, B]``) on the same states: the
    lander's (broadphase on, its world's own terrain) and the JAX tests'
    mixed world's: flags and weights equal, the active lanes' penetrations
    and points within 1e-5 (an inactive lane's are not read: a separated
    circle-box pair keeps its unclamped penetration in the per-world
    function, as in JAX, where the batched collide writes 0, and a
    separated polygon pair's clip points differ between the two JAX
    collides as well).  The
    batched step refuses a ``gjk_epa`` world with JAX's ``ValueError``,
    naming ``World.step``, the per-world path that runs it."""
    env = LunarLander(LanderConfig(), device="cpu")
    cases = [(env.world, lander_touch_state(env, B))]
    make, cfg, *_ = KIND_WORLDS["mixed"]
    world, state = World.build(make(BodyDef, tsh.box, tsh.circle, tsh.polygon),
                               WorldConfig(**cfg), device="cpu")
    cases.append((world, tb._from_soa(kinds_state("mixed", world, state, B))))
    for world, st in cases:
        got = world.detect_contacts(st)
        want = tb.collide_batched(world, tb._to_soa(st))
        assert torch.equal(got.active.T, want.active) and want.active.any()
        assert torch.equal(got.weight.T, want.weight)
        on = want.active
        for g, w in ((got.penetration[..., 0], want.pen_x), (got.penetration[..., 1], want.pen_y),
                     (got.point[..., 0], want.pt_x), (got.point[..., 1], want.pt_y)):
            torch.testing.assert_close(g.T[on], w[on], rtol=0, atol=ATOL)
    ref = LunarLander(LanderConfig(narrowphase="gjk_epa"), device="cpu")
    st = lander_touch_state(ref, 2)
    assert ref.world.detect_contacts(st).active.shape == (2, 24)
    with pytest.raises(ValueError, match="narrowphase='sat'.*World.step.*vmap"):
        tb.physics_core(ref.world, tb._to_soa(BodyState(*st)))
