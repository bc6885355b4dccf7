"""The port's per-world LunarLander (``reset_fn``, ``observe``, ``step_fn``
through ``Environment.step``) against ``jax.vmap`` of the JAX package's,
the model being ``tests/test_envs.py``.

Each world has its own terrain: ``_world_with_terrain`` gives the world a
``[B, P, V, 2]`` vertex table, and ``World.step`` collides each world
against its own ground.  Bars, each with its reason:

* the reset: bodies, terrain, keys and counters bit for bit (the port's
  threefry draws are jax's); ``prev_shaping`` within one float32 ulp
  (``safe_norm``'s ``sqrt`` of the same sum, rounded by two libraries);
* ten steps of B=8 worlds, world 0 pushed out of bounds (it crashes and
  resets onto a new terrain), world 1 dropped onto its pad with a sideways
  speed (the legs touch and slide), world 2 set down on its pad (it lands
  and resets): positions 1e-5, velocities 1e-4, reward and obs 1e-5,
  terrain, keys and every flag exact (``tests/test_batched_engine.py``'s
  bars);
* ``observe``: 1e-6 (one ulp of XLA's and torch's sine and cosine);
* one per-world step against the plane-space ``step_batch`` on the same
  states: positions 1e-5, velocities 1e-4, flags identical.

Each JAX reference is compiled once, in a module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_states import hold, jax_state, keys_np, np_tree, port_keys, state_dict

from parallax_tpu.envs.lunar_lander import LunarLander as JLander
from parallax_tpu_torch.envs.lunar_lander import LunarLander
from parallax_tpu_torch.utils import convert

torch.set_num_threads(2)
B = 8
BARS = {"bodies.pos": 1e-5, "bodies.vel": 1e-4, "bodies.angle": 1e-5, "bodies.omega": 1e-4,
        "prev_shaping": 1e-5}
TS_BARS = {"reward": 1e-5, "obs": 1e-5, "info.fuel": 0.0}


@pytest.fixture(scope="module")
def lander():
    jenv = JLander()
    return (LunarLander(device="cpu"), jenv, jax.jit(jax.vmap(jenv.reset_fn)),
            jax.jit(jax.vmap(jenv.step)))


def scene(d):
    """World 0 out of bounds, world 1 sliding on its pad, world 2 at rest
    on its pad (the lander and both legs moved; the ground stays)."""
    pos, vel = d["bodies.pos"].copy(), d["bodies.vel"].copy()
    pos[0, :3, 0] += 16.0
    pos[1, :3, 1] -= 6.25
    vel[1, :3, 0] = 0.2
    pos[2, :3, 1] -= 6.2
    return dict(d, **{"bodies.pos": pos, "bodies.vel": vel})


def _actions(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.0, 1.0, (n, B)), rng.uniform(-1.0, 1.0, (n, B))],
                    -1).astype(np.float32)


def test_reset_fn_matches_vmapped_jax(lander):
    env, _, jreset, _ = lander
    k = keys_np(B, 0)
    got = convert.lander_state_to_numpy(env.reset_fn(port_keys(k)))
    want = state_dict(jreset(jnp.asarray(k)))
    for f, w in want.items():
        if f == "prev_shaping":
            np.testing.assert_array_max_ulp(got[f], w, maxulp=1)
        else:
            np.testing.assert_array_equal(got[f], w, err_msg=f)
    one = convert.lander_state_to_numpy(env.reset(port_keys(k[3])))
    for f, g in one.items():
        np.testing.assert_array_equal(g, got[f][3], err_msg=f"one world's {f}")


def test_step_matches_vmapped_jax(lander):
    env, jenv, jreset, jstep = lander
    k = keys_np(B, 1)
    jst = jreset(jnp.asarray(k))
    d = scene(state_dict(jst))
    jst = jax_state(jst, d)
    st = convert.lander_state_from_numpy(d, "cpu")
    acts = _actions(10, 2)
    legs = reset = 0
    for t in range(10):
        st, ts = env.step(st, torch.from_numpy(acts[t]))
        jst, jts = jstep(jst, jnp.asarray(acts[t]))
        hold(np_tree(st), np_tree(jst), BARS, what=f"step {t}")
        hold(np_tree(ts), np_tree(jts), TS_BARS, what=f"TimeStep {t}")
        legs += int(ts.info["leg_contacts"][1].all())
        reset += int(ts.done[0]) + int(ts.done[2])
        if t == 0:
            assert bool(ts.info["crashed"][0]) and bool(ts.info["landed"][2])
    assert legs >= 5 and reset >= 2, (legs, reset)
    assert np.isfinite(st.bodies.pos.numpy()).all()


def test_observe_matches_jax(lander):
    env, jenv, jreset, _ = lander
    rng = np.random.default_rng(3)
    d = state_dict(jreset(jnp.asarray(keys_np(B, 3))))
    for f in ("bodies.pos", "bodies.vel", "bodies.angle", "bodies.omega"):
        d[f] = (d[f] + rng.standard_normal(d[f].shape)).astype(np.float32)
    d["leg_contacts"] = (rng.random((B, 2)) > 0.5).astype(np.float32)
    got = env.observe(convert.lander_state_from_numpy(d, "cpu")).numpy()
    want = np.asarray(jax.vmap(jenv.observe)(jax_state(jreset(jnp.asarray(keys_np(B, 3))), d)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    one = env.observe(convert.lander_state_from_numpy({f: v[4] for f, v in d.items()}, "cpu"))
    np.testing.assert_array_equal(one.numpy(), got[4])


def test_per_world_step_matches_plane_step(lander):
    """``Environment.step`` (``World.step`` per world) against the
    plane-space ``step_batch`` (``physics_core``'s block solve) from the
    same states, the contact scene included."""
    env, _, jreset, _ = lander
    d = scene(state_dict(jreset(jnp.asarray(keys_np(B, 4)))))
    a = torch.from_numpy(_actions(1, 5)[0])
    st, ts = env.step(convert.lander_state_from_numpy(d, "cpu"), a)
    pst, pts = env.step_batch(convert.lander_state_from_numpy(d, "cpu"), a)
    assert ts.info["leg_contacts"][1].all()
    np.testing.assert_allclose(st.bodies.pos.numpy(), pst.bodies.pos.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.bodies.vel.numpy(), pst.bodies.vel.numpy(), rtol=0, atol=1e-4)
    for f in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), getattr(pts, f).numpy())
    np.testing.assert_array_equal(st.key.numpy(), pst.key.numpy())
    np.testing.assert_array_equal(st.terrain.numpy(), pst.terrain.numpy())
    np.testing.assert_allclose(ts.reward.numpy(), pts.reward.numpy(), rtol=0, atol=1e-5)
