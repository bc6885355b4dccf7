"""The port's Bouncer (``parallax_tpu_torch/envs/bouncer.py``) on the CPU.

Bouncer is the smallest world with circle-circle (``cc``) and circle-box
(``cb``) pair groups: 6 balls and 4 static walls, zero gravity, the
symplectic integrator.  Its rollout is held against the JAX package's on
the same start states (keys from a numpy seed) and the policy of
``tests/test_plane_env.py``, within atol 1e-4: float32 rounding differs
between the frameworks (XLA fuses and sums in another order) and grows
over 50 contact steps, while 1e-4 stays far below any change of a contact
decision.  The other tests mirror ``tests/test_plane_env.py`` on the port
alone.  The JAX rollout is compiled once for the file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.envs.bouncer import Bouncer as JaxBouncer
from parallax_tpu_torch.envs.bouncer import Bouncer, BouncerConfig
from parallax_tpu_torch.utils.pytree import tree_leaves

torch.set_num_threads(2)

B, STEPS = 16, 50
ATOL = 1e-4


def _keys(batch, seed):
    k = np.random.default_rng(seed).integers(0, 2**32, (batch, 2), dtype=np.uint32)
    return k, torch.from_numpy(k.astype(np.int64))


def policy(_, obs):
    t = torch.sum(obs, dim=-1, keepdim=True)
    return 0.8 * torch.sin(t + torch.arange(2, dtype=torch.float32)[None])


def jax_policy(_, obs):
    t = jnp.sum(obs, axis=-1, keepdims=True)
    return 0.8 * jnp.sin(t + jnp.arange(2, dtype=jnp.float32)[None])


@pytest.fixture(scope="module")
def env():
    return Bouncer(device="cpu")


@pytest.fixture(scope="module")
def rollouts(env):
    """The port's and the JAX package's rollouts from the same states."""
    jenv = JaxBouncer()
    k_np, k = _keys(B, 0)
    jst = jenv.reset_fn_batch(jnp.asarray(k_np))
    want = jax.jit(lambda s: jenv.rollout_batch(s, jax_policy, STEPS))(jst)
    return jenv, env.rollout_batch(env.reset_fn_batch(k), policy, STEPS), want


def test_world_matches_jax(env, rollouts):
    """The pair table (groups, parts, lanes) and the body parameters are
    the JAX World's."""
    jw, w = rollouts[0].world, env.world
    assert [(g.kernel, g.part_a, g.part_b) for g in w.table.groups] == [
        (g.kernel, tuple(g.part_a), tuple(g.part_b)) for g in jw.table.groups
    ]
    assert [g.kernel for g in w.table.groups] == ["cc", "cb"]
    assert (w.table.n_contacts, w.n_bodies) == (jw.table.n_contacts, 10) == (39, 10)
    for f in ("body_a", "body_b", "partner"):
        assert tuple(getattr(w.table, f)) == tuple(getattr(jw.table, f)), f
    for f in ("mass", "inertia", "elasticity", "friction"):
        np.testing.assert_array_equal(getattr(w.params, f).numpy(),
                                      np.asarray(getattr(jw.params, f)), err_msg=f)
    np.testing.assert_array_equal(w.parts.verts.numpy(), np.asarray(jw.parts.verts))
    np.testing.assert_array_equal(w.parts.radius.numpy(), np.asarray(jw.parts.radius))
    assert w.parts.kind == tuple(jw.parts.kind)


def test_rollout_matches_jax(env, rollouts):
    """The generic rollout (``test_plane_env.py:22``), against JAX."""
    _, (fin, traj), (jfin, jtraj) = rollouts
    assert traj.obs.shape == (STEPS, B, env.observation_size)
    for name in ("obs", "reward"):
        np.testing.assert_allclose(getattr(traj, name).numpy(),
                                   np.asarray(getattr(jtraj, name)), atol=ATOL, rtol=0,
                                   err_msg=name)
    np.testing.assert_array_equal(traj.truncated.numpy(), np.asarray(jtraj.truncated))
    np.testing.assert_array_equal(fin.key.numpy(), np.asarray(jfin.key).astype(np.int64))
    np.testing.assert_allclose(fin.bodies.pos.numpy(), np.asarray(jfin.bodies.pos), atol=ATOL)
    # balls stay inside the walls, and ball 0 moves (thrust hook wired)
    n = env.config.n_balls
    assert torch.isfinite(traj.obs).all() and torch.isfinite(traj.reward).all()
    assert (traj.obs[..., :n].abs() < 2.5).all()
    assert fin.bodies.vel[:, 0].abs().max() > 1e-3


def test_watchdog_truncation_and_reset():
    """``max_steps`` truncation and the auto-reset (``test_plane_env.py:38``)."""
    env = Bouncer(BouncerConfig(max_steps=7), device="cpu")
    _, traj = env.rollout_batch(env.reset_fn_batch(_keys(4, 1)[1]), policy, 20)
    trunc = traj.truncated.numpy()
    assert trunc[6].all() and not trunc[:6].any()  # t hits 7 on step index 6
    assert trunc[13].all()  # the reset counter truncates again 7 steps later


def test_chunked_waves_match(env):
    """3 waves of 3 and a wave of 1 equal one wave of 10
    (``test_plane_env.py:49``): counters and keys bit for bit, the float
    state and the reward within 1e-6.  The JAX test holds the physics to
    the bit; here the policy's ``torch.sin`` of a one-world wave takes
    torch's scalar CPU path where the wide wave takes the vector one, and
    the two differ in the last bit of an action (measured: 4.8e-08)."""
    st = env.reset_fn_batch(_keys(10, 2)[1])
    f1, t1 = env.rollout_batch(st, policy, 12)
    f2, t2 = env.rollout_batch(st, policy, 12, max_chunk=3)
    for a, b in zip(tree_leaves(f1), tree_leaves(f2)):
        if a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
        else:
            assert torch.equal(a, b)
    np.testing.assert_allclose(t1.reward.numpy(), t2.reward.numpy(), rtol=0, atol=1e-6)


def test_reward_grad_finite_at_origin(env):
    """The reward ``-|pos|`` pulls ball 0 to the origin, the singular point
    of the norm's reverse-mode gradient: with the ball exactly there the
    plane path's gradient stays finite (``test_plane_env.py:83``).  Ball 0
    also starts at rest, so that it is still at the origin when the reward
    reads it."""
    st = env.reset_fn_batch(_keys(2, 0)[1])
    pos0, vel0 = st.bodies.pos.clone(), st.bodies.vel.clone()
    pos0[:, 0] = 0.0
    vel0[:, 0] = 0.0
    pos = pos0.requires_grad_(True)
    ps = env._to_planes(st._replace(bodies=st.bodies._replace(pos=pos, vel=vel0)))
    ps, ts = env._step_planes(ps, torch.zeros((2, 2)))
    assert (ps.s.px[0] == 0).all() and (ps.s.py[0] == 0).all()
    (g,) = torch.autograd.grad(ts.reward.sum(), pos)
    assert torch.isfinite(g).all()


def test_thrust_grad_matches_fd(env):
    """d(ball 0's final x)/d(thrust) through 20 steps with ball and wall
    contacts, by autograd of the plain torch ops against central
    differences (the bar of ``tests/test_grad_fd_oracle.py``: rtol 2e-2,
    atol 2e-4; float32 with a step of 1e-2)."""
    st = env.reset_fn_batch(_keys(2, 3)[1])
    T, H = 20, 1e-2

    def loss(theta):
        def pol(_, obs):
            return torch.stack([theta, 0.5 * theta]).expand(obs.shape[0], 2)

        final, _ = env.rollout_batch(st, pol, T)
        return final.bodies.pos[:, 0, 0].mean()

    theta = torch.tensor(0.4, requires_grad=True)
    (g,) = torch.autograd.grad(loss(theta), theta)
    with torch.no_grad():
        fd = (loss(torch.tensor(0.4 + H)) - loss(torch.tensor(0.4 - H))) / (2 * H)
    assert abs(g.item()) > 1e-3, "the thrust gradient must be alive"
    np.testing.assert_allclose(g.item(), fd.item(), rtol=2e-2, atol=2e-4)
