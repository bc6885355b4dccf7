"""The port's per-world ``parallel.rollout.rollout`` and ``batched_rollout``'s
fallback for an env without a plane-space fast path, against the JAX
package's, the models being ``tests/test_parallel.py``'s rollout cases.

On the Bouncer (B=4 worlds, a tanh-linear policy from numpy seeds):

* ``rollout`` with 0 and 2 checkpoint segments against
  ``jax.vmap(rollout)``, 6 steps: positions 1e-5, velocities 1e-4,
  reward and obs 1e-5, flags exact;
* ``batched_rollout`` on an env without ``rollout_batch`` runs
  ``rollout`` on the batch: the same trajectory bit for bit, time-major,
  ``traj_select`` applied after the fact, and the loud ``ValueError``s on
  ``max_chunk``, ``remat_steps``, ``mesh`` and segments that do not divide
  the steps;
* the gradient of the summed reward through ``rollout`` (2 segments)
  with respect to the policy against ``jax.grad`` of the unsegmented
  rollout (segments change no value, and JAX compiles it faster): 1e-4
  relative in norm per parameter (``tests/test_torch_train.py``'s bar);
* ``make_train_step`` on that env: its loss and gradients against the
  same env's plane-space path (1e-5 relative, 1e-4 relative in norm).

Each JAX reference is compiled once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_states import hold, keys_np, np_tree, state_dict

from parallax_tpu.envs.bouncer import Bouncer as JBouncer
from parallax_tpu.parallel.rollout import rollout as jax_rollout
from parallax_tpu_torch.envs.bouncer import Bouncer
from parallax_tpu_torch.parallel import rollout as prollout
from parallax_tpu_torch.utils import convert

torch.set_num_threads(2)
B, T = 4, 6
BARS = {"bodies.pos": 1e-5, "bodies.vel": 1e-4, "bodies.angle": 1e-5, "bodies.omega": 1e-4,
        "reward": 1e-5, "obs": 1e-5}


class PerWorldOnly:
    """An env seen through its per-world API only (no ``rollout_batch``)."""

    def __init__(self, env):
        self._env = env

    def __getattr__(self, name):
        if name in ("rollout_batch", "step_batch"):
            raise AttributeError(name)
        return getattr(self._env, name)


@pytest.fixture(scope="module")
def case():
    env, jenv = Bouncer(device="cpu"), JBouncer()
    rng = np.random.default_rng(0)
    params = {"w": (rng.standard_normal((env.observation_size, 2)) * 0.3).astype(np.float32),
              "b": (rng.standard_normal(2) * 0.1).astype(np.float32)}
    jst = jax.vmap(jenv.reset_fn)(jnp.asarray(keys_np(B, 1)))
    return env, jenv, params, jst


def policy(p, obs):
    return torch.tanh(obs @ p["w"] + p["b"])


def jpolicy(p, obs):
    return jnp.tanh(obs @ p["w"] + p["b"])


def _tparams(params, grad=False):
    return {k: torch.from_numpy(v.copy()).requires_grad_(grad) for k, v in params.items()}


def _start(env, jst):
    return convert.bouncer_state_from_numpy(state_dict(jst), "cpu")


@pytest.mark.parametrize("segments", [0, 2])
def test_rollout_matches_vmapped_jax(case, segments):
    env, jenv, params, jst = case
    final, traj = prollout.rollout(env, _start(env, jst), policy, _tparams(params), T, segments)
    jfinal, jtraj = jax.jit(jax.vmap(lambda s: jax_rollout(
        jenv, s, jpolicy, params, T, segments)))(jst)
    jtraj = jax.tree_util.tree_map(lambda x: jnp.swapaxes(x, 0, 1), jtraj)  # [T, B, ...]
    assert traj.reward.shape == (T, B)
    hold(np_tree(final), np_tree(jfinal), BARS, what="final")
    hold(np_tree(traj), np_tree(jtraj), BARS, what="trajectory")


def test_batched_rollout_fallback_and_its_errors(case):
    env, _, params, jst = case
    p = _tparams(params)
    wrapped = PerWorldOnly(env)
    final, traj = prollout.rollout(env, _start(env, jst), policy, p, T)
    f2, rewards = prollout.batched_rollout(wrapped, _start(env, jst), policy, p, T,
                                           traj_select=lambda ts: ts.reward)
    np.testing.assert_array_equal(rewards.numpy(), traj.reward.numpy())
    for a, b in zip(np_tree(f2).values(), np_tree(final).values()):
        np.testing.assert_array_equal(a, b)
    _, t3 = prollout.batched_rollout(wrapped, _start(env, jst), policy, p, T, checkpoint_segments=3)
    for a, b in zip(np_tree(t3).values(), np_tree(traj).values()):
        np.testing.assert_array_equal(a, b)
    for kw in ({"max_chunk": 2}, {"remat_steps": True}, {"mesh": object()}):
        with pytest.raises(ValueError, match="fast path"):
            prollout.batched_rollout(wrapped, _start(env, jst), policy, p, T, **kw)
    with pytest.raises(ValueError, match="must divide"):
        prollout.batched_rollout(wrapped, _start(env, jst), policy, p, T, checkpoint_segments=4)
    with pytest.raises(ValueError, match="must divide"):
        prollout.rollout(env, _start(env, jst), policy, p, T, checkpoint_segments=4)


def test_gradient_through_rollout_matches_jax(case):
    env, jenv, params, jst = case
    p = _tparams(params, grad=True)
    _, traj = prollout.rollout(env, _start(env, jst), policy, p, T, checkpoint_segments=2)
    traj.reward.sum().backward()

    def jloss(pp):
        _, tr = jax.vmap(lambda s: jax_rollout(jenv, s, jpolicy, pp, T))(jst)
        return tr.reward.sum()

    jg = jax.jit(jax.grad(jloss))(params)
    for k in params:
        g, w = p[k].grad.numpy(), np.asarray(jg[k])
        assert np.abs(w).max() > 0
        assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), k


def test_train_step_on_env_without_fast_path(case):
    """One ``make_train_step`` update on the per-world env and on the same
    env's plane-space path, from the same params and states."""
    env, _, params, jst = case
    out = []
    for e in (PerWorldOnly(env), env):
        p = _tparams(params, grad=True)
        loss_fn = prollout.make_loss_fn(e, policy, T, checkpoint_segments=2)
        loss, (final, _) = loss_fn(p, _start(env, jst))
        loss.backward()
        out.append((loss.item(), {k: v.grad.numpy().copy() for k, v in p.items()}))
        step = prollout.make_train_step(e, policy, prollout.adam(p), T, checkpoint_segments=2)
        p2, f2, m = step(p, _start(env, jst))
        assert np.isfinite(m["loss"].item()) and not f2.bodies.pos.requires_grad
    (l0, g0), (l1, g1) = out
    np.testing.assert_allclose(l0, l1, rtol=1e-5, atol=0)
    for k in g0:
        assert np.linalg.norm(g0[k] - g1[k]) <= 1e-4 * np.linalg.norm(g1[k]), k
