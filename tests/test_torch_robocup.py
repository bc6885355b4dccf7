"""The port's RoboCup (``parallax_tpu_torch/envs/robocup.py``) on the CPU.

RoboCup is a field of circles: a ball and robots, kept inside the field by
circle-in-area-box (``area_cb``) lanes, against each other (``cc``) and
against the goals' boxes (``cb``).  The port is held against the JAX
package's env on numpy inputs from seeds: its world table, its reset, one
``step_batch``, a 30-step rollout from the overlap state
(``tests/torch_scenarios.py:robocup_overlap_state``), the NaN watchdog,
the goal check of the verify skill and the train step.  Tolerances, each
with its reason:

* the pair table, lane constants, keys and reset poses: bit for bit;
  the ball's reset velocity is ``(cos, sin)`` of an angle drawn bit for
  bit, and XLA's and torch's CPU cosine and sine differ in the last bit
  for some angles, so it is held within one float32 ulp of a unit vector
  (1.2e-7);
* one step: obs and positions atol 1e-5, the bar of
  ``tests/test_batched_engine.py:118``;
* the rollout: obs and reward atol 1e-4 (float32 rounding differs between
  the frameworks and grows over 30 contact steps); termination and
  truncation equal;
* the train step: loss 1e-5 relative and each policy gradient 1e-4
  relative in norm, the bar of ``tests/test_torch_train.py``.

Each JAX reference is compiled once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_scenarios import robocup_overlap_state

from parallax_tpu.dynamics.bodies import BodyState as JaxBodyState
from parallax_tpu.envs.robocup import RoboCup as JaxRoboCup
from parallax_tpu.envs.robocup import RoboCupConfig as JaxRoboCupConfig
from parallax_tpu.envs.robocup import RoboCupState as JaxRoboCupState
from parallax_tpu.ops.pallas_solver import _build_operands
from parallax_tpu.parallel.rollout import make_train_step as jax_make_train_step
from parallax_tpu_torch.engine.batched import _from_soa
from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig
from parallax_tpu_torch.ops import contact_solver, fused_step
from parallax_tpu_torch.parallel import rollout
from parallax_tpu_torch.utils import convert, prng

torch.set_num_threads(2)

ATOL = 1e-4
TRAIN_B, HORIZON = 16, 12


def _keys(batch, seed):
    k = np.random.default_rng(seed).integers(0, 2**32, (batch, 2), dtype=np.uint32)
    return k, torch.from_numpy(k.astype(np.int64))


def to_jax(st):
    d = convert.robocup_state_to_numpy(st)
    return JaxRoboCupState(
        bodies=JaxBodyState(*(jnp.asarray(d[f"bodies.{f}"]) for f in ("pos", "vel", "angle", "omega"))),
        t=jnp.asarray(d["t"]),
        key=jnp.asarray(d["key"]),
    )


def overlap_states(env, B, seed=0):
    """Fresh states whose bodies take the overlap scenario's planes."""
    st = env.reset_fn_batch(_keys(B, seed + 1)[1])
    return st._replace(bodies=_from_soa(robocup_overlap_state(env, B, seed)))


@pytest.fixture(scope="module")
def env():
    return RoboCup(device="cpu")


@pytest.fixture(scope="module")
def jenv():
    return JaxRoboCup()


def test_world_table_and_reset_match_jax(env, jenv):
    t, jt = env.world.table, jenv.world.table
    assert [(g.kernel, g.size) for g in t.groups] == [("cc", 21), ("cb", 42), ("area_cb", 7)]
    assert (t.n_contacts, env.world.n_bodies) == (jt.n_contacts, 11) == (70, 11)
    for f in ("body_a", "body_b", "partner"):
        assert tuple(getattr(t, f)) == tuple(getattr(jt, f)), f
    assert [(g.kernel, g.part_a, g.part_b) for g in t.groups] == [
        (g.kernel, tuple(g.part_a), tuple(g.part_b)) for g in jt.groups]
    kinds = fused_step.fused_operands(env.world).pair_i[:, 7].tolist()
    assert kinds == [fused_step._KINDS[g.kernel] for g in t.groups for _ in g.part_a]
    ops = contact_solver.solver_operands(env.world, env.world.config.contact)
    np.testing.assert_array_equal(ops.lane_const.numpy(), _build_operands(jenv.world)["lane_const"][:6])

    k_np, k = _keys(16, 0)
    st = env.reset_fn_batch(k)
    jst = jax.jit(jenv.reset_fn_batch)(jnp.asarray(k_np))
    for f in ("pos", "angle", "omega"):
        np.testing.assert_array_equal(getattr(st.bodies, f).numpy(), np.asarray(getattr(jst.bodies, f)))
    np.testing.assert_array_equal(st.key.numpy(), np.asarray(jst.key).astype(np.int64))
    np.testing.assert_array_equal(st.t.numpy(), np.asarray(jst.t))
    vel, jvel = st.bodies.vel.numpy(), np.asarray(jst.bodies.vel)
    bi = env.ball_idx
    np.testing.assert_array_equal(np.delete(vel, bi, 1), np.delete(jvel, bi, 1))
    np.testing.assert_allclose(vel[:, bi], jvel[:, bi], rtol=0, atol=1.2e-7)
    ang = prng.uniform(prng.split(k)[:, 0], (), 0.0, 2 * np.pi)
    jang = jax.vmap(lambda kk: jax.random.uniform(jax.random.split(kk)[0], (), minval=0.0,
                                                  maxval=2 * jnp.pi))(jnp.asarray(k_np))
    np.testing.assert_array_equal(ang.numpy(), np.asarray(jang))
    # the auto-reset's fresh planes are the reset's
    fresh, _ = env.plane_fresh(k)
    np.testing.assert_array_equal(fresh.vx[bi].numpy(), vel[:, bi, 0])
    np.testing.assert_array_equal(fresh.vy[bi].numpy(), vel[:, bi, 1])


def test_step_batch_matches_jax():
    """The mirror of ``tests/test_batched_engine.py:118`` (two robots a team)."""
    env = RoboCup(RoboCupConfig(n_robots_per_team=2), device="cpu")
    jenv = JaxRoboCup(JaxRoboCupConfig(n_robots_per_team=2))
    B = 8
    st = env.reset_batch(_keys(B, 1)[1])
    acts = np.zeros((B, env.action_size), np.float32)
    acts[:, 0] = 1.0
    x1, t1 = env.step_batch(st, torch.from_numpy(acts))
    x2, t2 = jax.jit(jenv.step_batch)(to_jax(st), jnp.asarray(acts))
    assert np.abs(t1.obs.numpy() - np.asarray(t2.obs)).max() < 1e-5
    assert np.abs(x1.bodies.pos.numpy() - np.asarray(x2.bodies.pos)).max() < 1e-5
    np.testing.assert_allclose(t1.reward.numpy(), np.asarray(t2.reward), atol=1e-6)
    np.testing.assert_array_equal(t1.done.numpy(), np.asarray(t2.done))
    np.testing.assert_array_equal(x1.key.numpy(), np.asarray(x2.key).astype(np.int64))
    np.testing.assert_array_equal(x1.t.numpy(), np.asarray(x2.t))


def test_rollout_matches_jax_from_the_overlap_state(env, jenv):
    B, T = 8, 30
    st = overlap_states(env, B)
    W = (np.random.default_rng(3).standard_normal((env.observation_size, env.action_size))
         * 0.5).astype(np.float32)

    def pol(_, obs):
        return torch.tanh(obs @ torch.from_numpy(W))

    def jpol(_, obs):
        return jnp.tanh(obs @ jnp.asarray(W))

    fin, traj = env.rollout_batch(st, pol, T)
    jfin, jtraj = jax.jit(lambda s: jenv.rollout_batch(s, jpol, T))(to_jax(st))
    assert traj.obs.shape == (T, B, env.observation_size)
    for name in ("obs", "reward"):
        np.testing.assert_allclose(getattr(traj, name).numpy(), np.asarray(getattr(jtraj, name)),
                                   atol=ATOL, rtol=0, err_msg=name)
    for name in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(traj, name).numpy(), np.asarray(getattr(jtraj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(traj.info["ball_speed"].numpy(), np.asarray(jtraj.info["ball_speed"]),
                               atol=ATOL)
    np.testing.assert_array_equal(fin.key.numpy(), np.asarray(jfin.key).astype(np.int64))
    np.testing.assert_allclose(fin.bodies.pos.numpy(), np.asarray(jfin.bodies.pos), atol=ATOL)


def test_nan_ball_velocity_zeroes_info_and_truncates(env):
    """The mirror of ``tests/test_plane_env.py:176`` through ``rollout_batch``,
    and the same poison through ``step_batch``: the poisoned world is
    truncated, every float info leaf, its reward and its obs are zero, and
    it restarts finite; the other worlds go on."""
    B, w = 4, 3
    st = env.reset_fn_batch(_keys(B, 0)[1])
    vel = st.bodies.vel.clone()
    vel[w, env.ball_idx, 0] = float("nan")
    st = st._replace(bodies=st.bodies._replace(vel=vel))

    def zero(_, obs):
        return torch.zeros((obs.shape[0], env.action_size))

    final, traj = env.rollout_batch(st, zero, 3)
    assert traj.truncated[0, w] and not traj.truncated[0, [0, 1, 2]].any()
    for name, leaf in traj.info.items():
        if leaf.is_floating_point():
            assert torch.isfinite(leaf).all() and (leaf[0, w] == 0).all(), name
    assert (traj.reward[0, w] == 0) and (traj.obs[0, w] == 0).all()
    assert not traj.truncated[1:].any() and torch.isfinite(final.bodies.vel).all()

    new, ts = env.step_batch(st, torch.zeros((B, env.action_size)))
    assert ts.truncated.tolist() == [False, False, False, True]
    assert ts.reward[w] == 0 and (ts.obs[w] == 0).all() and ts.info["ball_speed"][w] == 0
    assert torch.isfinite(ts.obs).all() and torch.isfinite(new.bodies.vel).all()
    assert new.t.tolist() == [1, 1, 1, 0]


def test_goal_shots_terminate_with_plus_minus_one(env):
    """The verify skill's goal check: the ball shot into the yellow goal
    (world 0: blue scores) or the blue goal (world 1: yellow scores) ends
    the episode with a reward of +1 or -1 (and the small progress term)."""
    st = env.reset_fn_batch(_keys(2, 5)[1])
    pos, vel = st.bodies.pos.clone(), st.bodies.vel.clone()
    side = torch.tensor([-1.0, 1.0])
    pos[:, env.ball_idx] = torch.stack([side * 4.3, torch.zeros(2)], -1)
    vel[:, env.ball_idx] = torch.stack([side * 3.0, torch.zeros(2)], -1)
    st = st._replace(bodies=st.bodies._replace(pos=pos, vel=vel))
    _, traj = env.rollout_batch(st, lambda _, o: torch.zeros((o.shape[0], env.action_size)), 20)
    for w, key in ((0, "blue_scored"), (1, "yellow_scored")):
        assert traj.terminated[:, w].any(), f"no goal in world {w} in 20 steps"
        t = int(np.argmax(traj.terminated[:, w].numpy()))
        np.testing.assert_allclose(traj.reward[t, w].item(), -side[w].item(), atol=1e-3)
        assert traj.info[key][t, w] and not traj.terminated[:t, w].any()


def mlp_arrays(env):
    """``bench.py --train``'s 32-wide tanh MLP, from a numpy seed."""
    rng = np.random.default_rng(0)
    return {
        "w1": (rng.standard_normal((env.observation_size, 32)) * 0.3).astype(np.float32),
        "b1": np.zeros(32, np.float32),
        "w2": (rng.standard_normal((32, env.action_size)) * 0.1).astype(np.float32),
        "b2": np.zeros(env.action_size, np.float32),
    }


def test_train_step_loss_and_grads_match_jax(env, jenv):
    """The loss and policy gradients of one train step (B=16, h=12) from the
    overlap state against JAX's ``make_train_step``; its optimizer keeps
    the gradients as its state, so they come out unrounded.  The reward
    moves with the ball's x at 1e-4 a step, so the gradients are small;
    they reach the policy only through the robots' contacts with the ball."""
    st = overlap_states(env, TRAIN_B, seed=2)
    arrays = mlp_arrays(env)
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )

    def jpolicy(p, obs):
        return jnp.tanh(jnp.tanh(obs @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])

    def policy(p, obs):
        return torch.tanh(torch.tanh(obs @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])

    jparams = {k: jnp.asarray(v) for k, v in arrays.items()}
    step = jax.jit(jax_make_train_step(jenv, jpolicy, keep, HORIZON))
    _, grads_j, _, metrics = step(jparams, keep.init(jparams), to_jax(st))
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in arrays.items()}
    loss, _ = rollout.make_loss_fn(env, policy, HORIZON)(params, st)
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=1e-5)
    for k, g in zip(params, grads):
        ref = np.asarray(grads_j[k])
        assert np.linalg.norm(ref) > 1e-7, f"{k}: gradient must be alive"
        rel = np.linalg.norm(g.numpy() - ref) / np.linalg.norm(ref)
        assert rel < 1e-4, (k, rel)
