"""The port's per-world RoboCup (``reset_fn``, ``observe``, ``step_fn``
through ``Environment.step``) against ``jax.vmap`` of the JAX package's,
the model being ``tests/test_envs.py``, and the constructor's repair: it
builds the reference-parity worlds, and the batched path refuses them.

Bars, each with its reason:

* the reset: keys, counters, positions and every velocity but the ball's
  bit for bit; the ball's is ``(cos, sin)`` of an angle drawn bit for bit,
  and XLA's and torch's CPU cosine and sine differ in the last bit for
  some angles: one float32 ulp of a unit vector (1.2e-7);
* ten steps of B=8 worlds, world 0's ball shot into the yellow goal (blue
  scores, the episode ends and resets), world 1's robots driven into each
  other: positions 1e-5, velocities 1e-4, reward and obs 1e-5, flags
  exact;
* ``observe``: bit for bit (a gather);
* one per-world step against the plane-space ``step_batch``: positions
  1e-5, velocities 1e-4, flags identical.

Each JAX reference is compiled once, in a module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_states import hold, jax_state, keys_np, np_tree, port_keys, state_dict

from parallax_tpu.envs.robocup import RoboCup as JRoboCup
from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig
from parallax_tpu_torch.utils import convert

torch.set_num_threads(2)
B = 8
BARS = {"bodies.pos": 1e-5, "bodies.vel": 1e-4, "bodies.angle": 1e-5, "bodies.omega": 1e-4}
TS_BARS = {"reward": 1e-5, "obs": 1e-5, "info.ball_speed": 1e-4}


@pytest.fixture(scope="module")
def robocup():
    jenv = JRoboCup()
    return (RoboCup(device="cpu"), jenv, jax.jit(jax.vmap(jenv.reset_fn)),
            jax.jit(jax.vmap(jenv.step)))


def scene(env, d):
    """World 0's ball at x=-4.5 flying into the yellow goal; world 1's first
    blue robot beside its first yellow one."""
    pos, vel = d["bodies.pos"].copy(), d["bodies.vel"].copy()
    bi, r0 = env.ball_idx, int(env.robot_idx[0])
    pos[0, bi], vel[0, bi] = (-4.5, 0.0), (-3.0, 0.0)
    pos[1, r0] = pos[1, r0 + env.config.n_robots_per_team] + np.float32([0.15, 0.0])
    return dict(d, **{"bodies.pos": pos, "bodies.vel": vel})


def _actions(env, n, seed):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (n, B, env.action_size)).astype(np.float32)


def test_reset_fn_matches_vmapped_jax(robocup):
    env, _, jreset, _ = robocup
    k = keys_np(B, 0)
    got = convert.robocup_state_to_numpy(env.reset_fn(port_keys(k)))
    want = state_dict(jreset(jnp.asarray(k)))
    bi = env.ball_idx
    for f, w in want.items():
        if f == "bodies.vel":
            np.testing.assert_array_equal(np.delete(got[f], bi, 1), np.delete(w, bi, 1))
            np.testing.assert_allclose(got[f][:, bi], w[:, bi], rtol=0, atol=1.2e-7)
        else:
            np.testing.assert_array_equal(got[f], w, err_msg=f)
    one = convert.robocup_state_to_numpy(env.reset(port_keys(k[5])))
    for f, g in one.items():
        np.testing.assert_array_equal(g, got[f][5], err_msg=f"one world's {f}")


def test_step_matches_vmapped_jax(robocup):
    env, _, jreset, jstep = robocup
    k = keys_np(B, 1)
    jst = jreset(jnp.asarray(k))
    d = scene(env, state_dict(jst))
    jst = jax_state(jst, d)
    st = convert.robocup_state_from_numpy(d, "cpu")
    acts = _actions(env, 10, 2)
    scored = 0
    for t in range(10):
        st, ts = env.step(st, torch.from_numpy(acts[t]))
        jst, jts = jstep(jst, jnp.asarray(acts[t]))
        hold(np_tree(st), np_tree(jst), BARS, what=f"step {t}")
        hold(np_tree(ts), np_tree(jts), TS_BARS, what=f"TimeStep {t}")
        scored += int(ts.info["blue_scored"][0])
    assert scored == 1 and np.isfinite(st.bodies.pos.numpy()).all()


def test_observe_matches_jax(robocup):
    env, jenv, jreset, _ = robocup
    rng = np.random.default_rng(3)
    jst = jreset(jnp.asarray(keys_np(B, 3)))
    d = state_dict(jst)
    for f in ("bodies.pos", "bodies.vel"):
        d[f] = (d[f] + rng.standard_normal(d[f].shape)).astype(np.float32)
    got = env.observe(convert.robocup_state_from_numpy(d, "cpu")).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.vmap(jenv.observe)(jax_state(jst, d))))
    one = env.observe(convert.robocup_state_from_numpy({f: v[6] for f, v in d.items()}, "cpu"))
    np.testing.assert_array_equal(one.numpy(), got[6])


def test_per_world_step_matches_plane_step(robocup):
    env, _, jreset, _ = robocup
    d = scene(env, state_dict(jreset(jnp.asarray(keys_np(B, 4)))))
    a = torch.from_numpy(_actions(env, 1, 5)[0])
    st, ts = env.step(convert.robocup_state_from_numpy(d, "cpu"), a)
    pst, pts = env.step_batch(convert.robocup_state_from_numpy(d, "cpu"), a)
    np.testing.assert_allclose(st.bodies.pos.numpy(), pst.bodies.pos.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.bodies.vel.numpy(), pst.bodies.vel.numpy(), rtol=0, atol=1e-4)
    for f in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), getattr(pts, f).numpy())
    np.testing.assert_array_equal(st.key.numpy(), pst.key.numpy())
    np.testing.assert_allclose(ts.reward.numpy(), pts.reward.numpy(), rtol=0, atol=1e-5)


def test_reference_mode_constructs_and_batched_path_refuses():
    """``RoboCupConfig(narrowphase="gjk_epa",
    solver_mode="random_one_per_body")`` constructs (golden config 5's
    world), its per-world step runs (finite, the bodies move), and its
    ``rollout_batch`` and ``step_batch`` raise ``ValueError`` before they
    step anything, as the JAX package's batched path does."""
    env = RoboCup(RoboCupConfig(narrowphase="gjk_epa", solver_mode="random_one_per_body"),
                  device="cpu")
    st = env.reset(port_keys(keys_np(2, 7)))
    a = torch.from_numpy(np.full((2, env.action_size), 0.5, np.float32))
    out, ts = env.step(st, a)
    assert np.isfinite(out.bodies.pos.numpy()).all() and np.isfinite(ts.reward.numpy()).all()
    assert (out.bodies.pos != st.bodies.pos).any()
    with pytest.raises(ValueError, match="gjk_epa"):
        env.rollout_batch(st, lambda p, obs: a, 2)
    with pytest.raises(ValueError, match="gjk_epa"):
        env.step_batch(st, a)
