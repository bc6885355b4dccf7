"""The port's Billiards (``parallax_tpu_torch/envs/billiards.py``) on the CPU.

Billiards is a zero-gravity table of circle balls and four cushion boxes:
circle-circle (``cc``) and circle-box (``cb``) pair groups on the split
step.  Its rollout is held against the JAX package's through a pot and the
auto-reset that follows (the setup of ``tests/test_billiards.py:95``), and
its gradient through 20 steps against ``jax.grad``.  Inputs come from numpy
seeds.  Tolerances, each with its reason:

* the reset jitter and the PRNG keys: bit for bit (``utils/prng.py``
  reproduces jax's threefry and uniform draws);
* obs and reward: atol 1e-4, as for the other envs' rollouts (float32
  rounding differs between the frameworks and grows over 60 contact
  steps); termination, truncation and the potted flags: equal;
* the gradient: 1e-4 relative, the bar of ``tests/test_torch_train.py``
  between the port's and JAX's gradients through contact steps.

Each JAX reference is compiled once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.envs.billiards import Billiards as JaxBilliards
from parallax_tpu.envs.billiards import BilliardsConfig as JaxBilliardsConfig
from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig

torch.set_num_threads(2)

ATOL = 1e-4


def _keys(batch, seed):
    k = np.random.default_rng(seed).integers(0, 2**32, (batch, 2), dtype=np.uint32)
    return k, torch.from_numpy(k.astype(np.int64))


def _scratch_cue(pos, vel):
    """World 0's cue heads for the top-right pocket (``test_billiards.py:95``)."""
    pos[0, 0] = torch.tensor([0.85, 0.42])
    vel[0, 0] = torch.tensor([1.5, 0.8])
    return pos, vel


def _to_jax(jenv, st):
    b = st.bodies
    return jenv.reset_fn_batch(jnp.zeros((st.t.shape[0], 2), jnp.uint32)).replace(
        bodies=jenv._init_bodies.replace(
            pos=jnp.asarray(b.pos.numpy()), vel=jnp.asarray(b.vel.numpy()),
            angle=jnp.asarray(b.angle.numpy()), omega=jnp.asarray(b.omega.numpy()),
        ),
        potted=jnp.asarray(st.potted.numpy()),
        t=jnp.asarray(st.t.numpy()),
        key=jnp.asarray(st.key.numpy().astype(np.uint32)),
    )


def test_rollout_matches_jax_through_a_pot_and_reset():
    B, T = 4, 60
    env = Billiards(BilliardsConfig(n_object=2), device="cpu")
    jenv = JaxBilliards(JaxBilliardsConfig(n_object=2))
    k_np, k = _keys(B, 0)
    st = env.reset_fn_batch(k)
    jst = jenv.reset_fn_batch(jnp.asarray(k_np))
    # the reset jitter and the carried keys are jax's to the bit
    np.testing.assert_array_equal(st.bodies.pos.numpy(), np.asarray(jst.bodies.pos))
    np.testing.assert_array_equal(st.key.numpy(), np.asarray(jst.key).astype(np.int64))
    pos, vel = _scratch_cue(st.bodies.pos.clone(), st.bodies.vel.clone())
    st = st._replace(bodies=st.bodies._replace(pos=pos, vel=vel))

    def pol(_, obs):
        return torch.tensor([[0.3, 0.0]]).expand(obs.shape[0], 2)

    def jpol(_, obs):
        return jnp.tile(jnp.asarray([[0.3, 0.0]]), (obs.shape[0], 1))

    fin, traj = env.rollout_batch(st, pol, T)
    jfin, jtraj = jax.jit(lambda s: jenv.rollout_batch(s, jpol, T))(_to_jax(jenv, st))
    assert traj.done.any(), "no reset happened in the window"
    assert traj.obs.shape == (T, B, env.observation_size)
    for name in ("obs", "reward"):
        np.testing.assert_allclose(getattr(traj, name).numpy(),
                                   np.asarray(getattr(jtraj, name)), atol=ATOL, rtol=0,
                                   err_msg=name)
    for name in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(traj, name).numpy(),
                                      np.asarray(getattr(jtraj, name)), err_msg=name)
    for name in ("cue_lost", "cleared"):
        np.testing.assert_array_equal(traj.info[name].numpy(), np.asarray(jtraj.info[name]))
    np.testing.assert_array_equal(fin.potted.numpy(), np.asarray(jfin.potted))
    np.testing.assert_array_equal(fin.key.numpy(), np.asarray(jfin.key).astype(np.int64))
    np.testing.assert_allclose(fin.bodies.pos.numpy(), np.asarray(jfin.bodies.pos), atol=ATOL)
    # the reset world restarts from the rack, jittered by jax's draws
    step = int(np.argmax(traj.done[:, 0].numpy()))
    assert traj.info["cue_lost"][step, 0]
    np.testing.assert_array_equal(traj.obs[step + 1, 0].numpy(),
                                  np.asarray(jtraj.obs[step + 1, 0]))


@pytest.mark.parametrize("ball", [0, 1])
def test_pots_reward_park_terminate_and_reset(ball):
    """A ball rolled into a corner pocket (``test_billiards.py:29`` and
    ``:52``): the cue costs the cue penalty and ends the episode, which the
    auto-reset restarts from the rack; an object ball earns the pot reward
    and is parked above the table, at rest, while the episode goes on."""
    env = Billiards(device="cpu")
    B = 2
    st = env.reset_fn_batch(_keys(B, 1)[1])
    pos, vel = st.bodies.pos.clone(), st.bodies.vel.clone()
    if ball == 0:
        pos[:, 0] = torch.tensor([-0.8, -0.4])
        vel[:, 0] = torch.tensor([-1.0, -0.5])
    else:
        pos[:, 1] = torch.tensor([0.8, 0.4])
        vel[:, 1] = torch.tensor([1.0, 0.5])
    st = st._replace(bodies=st.bodies._replace(pos=pos, vel=vel))
    fin, traj = env.rollout_batch(st, lambda _, o: torch.zeros((o.shape[0], 2)), 40)
    obs = traj.obs.numpy()  # per ball: x, y, vx, vy, potted
    potted = obs[..., 5 * ball + 4] > 0.5
    assert potted.any(0).all(), "the ball must be potted in every world"
    t = int(np.argmax(potted[:, 0]))
    if ball == 0:
        assert traj.terminated[t].all() and traj.info["cue_lost"][t].all()
        assert (traj.reward[t] < -0.9).all()
        # auto-reset: potted flags cleared, the cue back near its spot
        assert not fin.potted.any()
        assert (fin.bodies.pos[:, 0, 0] + 0.5).abs().max() < 0.05
    else:
        assert (traj.reward[t] > 0.9).all() and not traj.done[: t + 1].any()
        assert (obs[t:, :, 5 * ball + 1] > 5.0).all()  # parked above the table
        assert (obs[t:, :, 5 * ball + 2: 5 * ball + 4] == 0).all()  # at rest
        assert fin.potted[:, ball].all()


def test_billiards48_pair_table_matches_jax():
    """``bench.py``'s stress world, 47 object balls: 52 bodies, 1128 cc and
    192 cb lanes, the JAX World's table lane for lane."""
    env = Billiards(BilliardsConfig(n_object=47), device="cpu")
    jw = JaxBilliards(JaxBilliardsConfig(n_object=47)).world
    t = env.world.table
    assert [(g.kernel, g.size) for g in t.groups] == [("cc", 1128), ("cb", 192)]
    assert (t.n_contacts, env.world.n_bodies) == (jw.table.n_contacts, 52) == (1320, 52)
    for f in ("body_a", "body_b", "partner"):
        assert tuple(getattr(t, f)) == tuple(getattr(jw.table, f)), f
    assert [(g.part_a, g.part_b) for g in t.groups] == [
        (tuple(g.part_a), tuple(g.part_b)) for g in jw.table.groups
    ]
    np.testing.assert_array_equal(env.world.parts.verts.numpy(), np.asarray(jw.parts.verts))


def test_grad_through_billiards_matches_jax():
    """d(mean cue x after 20 split steps)/d(cue thrust), by autograd of the
    plain torch ops, against ``jax.grad`` of the JAX rollout
    (``test_billiards.py:75``): the same value within 1e-4 relative, and
    positive (pushing right moves the cue right).  The cue moves about
    0.03 and touches neither the ball nor a cushion, so no contact lane is
    active here: the gradient through the cc and cb lanes is held against
    ``jax.vjp`` in ``test_torch_fused_circle_box.py``."""
    B, T = 4, 20
    env = Billiards(BilliardsConfig(n_object=1), device="cpu")
    jenv = JaxBilliards(JaxBilliardsConfig(n_object=1))
    k_np, k = _keys(B, 2)
    st = env.reset_fn_batch(k)
    jst = jenv.reset_fn_batch(jnp.asarray(k_np))

    def loss(theta):
        def pol(_, obs):
            return torch.stack([theta, 0.0 * theta]).expand(obs.shape[0], 2)

        return env.rollout_batch(st, pol, T)[0].bodies.pos[:, 0, 0].mean()

    def jloss(theta):
        def pol(_, obs):
            return jnp.tile(jnp.stack([theta, jnp.zeros(())])[None], (obs.shape[0], 1))

        return jenv.rollout_batch(jst, pol, T)[0].bodies.pos[:, 0, 0].mean()

    theta = torch.tensor(0.5, requires_grad=True)
    (g,) = torch.autograd.grad(loss(theta), theta)
    want = float(jax.jit(jax.grad(jloss))(jnp.asarray(0.5)))
    assert np.isfinite(g.item()) and g.item() > 0
    np.testing.assert_allclose(g.item(), want, rtol=1e-4)
