"""The port's per-world env API (``parallax_tpu_torch/envs/base.py``) against
the JAX package's, the model being ``tests/test_envs.py``.

A per-world function of the port on ``[B, ...]`` states is the port of
``jax.vmap`` of JAX's.  Held here, on numpy-seeded inputs:

* ``utils/prng.fold_in`` against ``jax.random.fold_in``: bit for bit;
* ``utils/pytree.tree_select`` against JAX's ``tree_select``: bit for bit;
* ``Environment.step``'s auto-reset (``split(key) -> (reset, carry)``, a
  fresh ``reset_fn``, the select on ``done``) against ``jax.vmap(env.step)``
  on Billiards, whose reset draws from its key: keys, counters and the
  reset worlds' racks bit for bit;
* the per-world NaN watchdog: one poisoned world of B=8 is truncated and
  reset, its emissions zeroed, and every other world's bits are those of
  the clean step; ``BatchedEnvironmentMixin.step_batch`` gives the same
  bits;
* Bouncer's and Billiards' ``step`` against ``jax.vmap(env.step)``, B=8,
  5 steps: positions 1e-5, velocities 1e-4, reward and obs 1e-5, flags
  exact (the bars of ``tests/test_batched_engine.py``).

Each JAX reference is compiled once, in a module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_states import hold, jax_state, keys_np, np_tree, port_keys, state_dict

from parallax_tpu.envs.billiards import Billiards as JBilliards
from parallax_tpu.envs.bouncer import Bouncer as JBouncer
from parallax_tpu.utils.pytree import tree_select as jtree_select
from parallax_tpu_torch.envs.base import BatchedEnvironmentMixin
from parallax_tpu_torch.envs.billiards import Billiards
from parallax_tpu_torch.envs.bouncer import Bouncer
from parallax_tpu_torch.utils import convert, prng
from parallax_tpu_torch.utils.pytree import tree_select

torch.set_num_threads(2)
B = 8
BARS = {"bodies.pos": 1e-5, "bodies.vel": 1e-4, "bodies.angle": 1e-5, "bodies.omega": 1e-4}
TS_BARS = {"reward": 1e-5, "obs": 1e-5}


@pytest.fixture(scope="module")
def envs():
    """name -> (port env, JAX env, jit(vmap(reset_fn)), jit(vmap(step)),
    the port's state converter)."""
    out = {}
    for name, cls, jcls, conv in (
        ("bouncer", Bouncer, JBouncer, convert.bouncer_state_from_numpy),
        ("billiards", Billiards, JBilliards, convert.billiards_state_from_numpy),
    ):
        jenv = jcls()
        out[name] = (cls(device="cpu"), jenv, jax.jit(jax.vmap(jenv.reset_fn)),
                     jax.jit(jax.vmap(jenv.step)), conv)
    return out


def _actions(n, seed, scale=1.0):
    return np.random.default_rng(seed).uniform(-scale, scale, (n, B, 2)).astype(np.float32)


def test_fold_in_matches_jax_bitwise():
    """``fold_in`` on 64 keys and the data words the envs fold in (the
    lander's 0x501E, RoboCup's 0x50CC), 0 and 2**32 - 1."""
    k = keys_np(64, 3)
    for data in (0, 1, 0x501E, 0x50CC, 2**31 + 7, 2**32 - 1):
        got = prng.fold_in(port_keys(k), data).numpy()
        want = np.asarray(jax.vmap(lambda kk: jax.random.fold_in(kk, data))(jnp.asarray(k)))
        np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=f"data={data}")
    one = prng.fold_in(port_keys(k[0]), 0x501E).numpy()
    np.testing.assert_array_equal(one, np.asarray(jax.random.fold_in(jnp.asarray(k[0]), 0x501E)))


def test_tree_select_matches_jax():
    """A tree of leaves ``[B]``, ``[B, 3]`` and ``[B, 2, 2]`` (float, int,
    bool) under a ``[B]`` predicate, and under a scalar one."""
    rng = np.random.default_rng(0)
    a = {"x": rng.standard_normal(B).astype(np.float32),
         "y": (rng.standard_normal((B, 3)).astype(np.float32), rng.integers(0, 9, (B, 2, 2))),
         "z": rng.random((B, 2)) > 0.5}
    b = {"x": rng.standard_normal(B).astype(np.float32),
         "y": (rng.standard_normal((B, 3)).astype(np.float32), rng.integers(0, 9, (B, 2, 2))),
         "z": rng.random((B, 2)) > 0.5}
    for pred in (rng.random(B) > 0.5, np.bool_(True), np.bool_(False)):
        got = tree_select(torch.as_tensor(pred), jax.tree_util.tree_map(torch.as_tensor, a),
                          jax.tree_util.tree_map(torch.as_tensor, b))
        want = jtree_select(jnp.asarray(pred), a, b)
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_auto_reset_key_split_matches_jax(envs):
    """Four of eight billiards worlds at their last step: ``Environment.step``
    truncates and resets them with racks drawn from ``split(key)[0]`` and
    carries ``split(key)[1]`` in every world, as ``jax.vmap(env.step)``."""
    env, jenv, jreset, jstep, conv = envs["billiards"]
    k = keys_np(B, 11)
    d = state_dict(jreset(jnp.asarray(k)))
    d["t"] = np.where(np.arange(B) < 4, env.config.max_steps - 1, 3).astype(np.int32)
    a = _actions(1, 12)[0]
    st, ts = env.step(conv(d, "cpu"), torch.from_numpy(a))
    jst, jts = jstep(jax_state(jenv.reset_fn(jnp.asarray(k[0])), d), jnp.asarray(a))
    got, want = convert.billiards_state_to_numpy(st), state_dict(jst)
    assert ts.truncated[:4].all() and not ts.done[4:].any()
    for f in ("key", "t", "potted"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("bodies.pos", "bodies.vel", "bodies.angle", "bodies.omega"):
        np.testing.assert_array_equal(got[f][:4], want[f][:4], err_msg=f"reset worlds' {f}")
    hold(got, want, BARS, what="auto-reset step")
    hold(np_tree(ts), np_tree(jts), TS_BARS, what="auto-reset TimeStep")


def test_watchdog_resets_only_the_poisoned_world(envs):
    """NaN in world 5's positions: world 5 is truncated, its reward, obs and
    info zeroed, and its state is the fresh reset of its reset key; the
    seven others equal the clean step bit for bit; JAX flags the same."""
    env, jenv, jreset, jstep, conv = envs["bouncer"]
    k = keys_np(B, 5)
    d = state_dict(jreset(jnp.asarray(k)))
    a = torch.from_numpy(_actions(1, 6)[0])
    clean, cts = env.step(conv(d, "cpu"), a)
    d["bodies.pos"] = d["bodies.pos"].copy()
    d["bodies.pos"][5, 2] = np.nan
    st, ts = env.step(conv(d, "cpu"), a)

    assert ts.truncated.tolist() == [i == 5 for i in range(B)]
    assert ts.reward[5] == 0 and (ts.obs[5] == 0).all()
    fresh = env.reset_fn(prng.split(port_keys(k))[5, 0])
    for g, c, f in zip(st.bodies, clean.bodies, fresh.bodies):
        np.testing.assert_array_equal(g[5].numpy(), f.numpy())
        np.testing.assert_array_equal(np.delete(g.numpy(), 5, 0), np.delete(c.numpy(), 5, 0))
    assert st.t[5] == 0 and (st.t == clean.t).sum() == B - 1
    np.testing.assert_array_equal(st.key.numpy(), clean.key.numpy())
    keep = np.arange(B) != 5
    for g, c in zip(np_tree(ts).values(), np_tree(cts).values()):
        np.testing.assert_array_equal(g[keep], c[keep])

    _, jts = jstep(jax_state(jenv.reset_fn(jnp.asarray(k[0])), d), jnp.asarray(a.numpy()))
    np.testing.assert_array_equal(ts.truncated.numpy(), np.asarray(jts.truncated))
    # BatchedEnvironmentMixin.step_batch (step_fn on the batch, its own
    # watchdog and key split; the envs take PlaneEnvMixin's) gives the bits
    # of env.step
    mst, mts = BatchedEnvironmentMixin.step_batch(env, conv(d, "cpu"), a)
    for got, via_mixin in ((st, mst), (ts, mts)):
        for g, m in zip(np_tree(got).values(), np_tree(via_mixin).values()):
            np.testing.assert_array_equal(g, m)


@pytest.mark.parametrize("name", ["bouncer", "billiards"])
def test_step_matches_vmapped_jax(envs, name):
    """Five per-world steps of B=8 worlds under seeded actions, each side
    from its own previous state, against ``jax.vmap(env.step)``."""
    env, jenv, jreset, jstep, conv = envs[name]
    k = keys_np(B, 21)
    jst = jreset(jnp.asarray(k))
    st = conv(state_dict(jst), "cpu")
    hold(np_tree(env.reset_fn(port_keys(k))), np_tree(jst), {}, what=f"{name} reset")
    acts = _actions(5, 22)
    moved = 0.0
    for t in range(5):
        st, ts = env.step(st, torch.from_numpy(acts[t]))
        jst, jts = jstep(jst, jnp.asarray(acts[t]))
        hold(np_tree(st), np_tree(jst), BARS, what=f"{name} step {t}")
        hold(np_tree(ts), np_tree(jts), TS_BARS, what=f"{name} TimeStep {t}")
        moved = max(moved, float(np.abs(ts.obs.numpy()).max()))
    assert moved > 0 and np.isfinite(st.bodies.pos.numpy()).all()
