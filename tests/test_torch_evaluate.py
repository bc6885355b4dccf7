"""The port's continuous-time ``evaluate`` (``envs/base.py``: the NFE/WFE
loop with its Judges and Controls) against the JAX package's, the model
being ``tests/test_envs.py``'s evaluate cases.

* ``test_envs.py``'s toy world (x' = u, reward x, done at x >= 1): the
  port's reward and frozen state equal JAX's within 1e-6, and the toy's
  own bounds hold; a ``PolicyControl`` that answers 1 gives the same bits;
* the lander (``LanderJudge``, ``make_world_forward``) drifting out of
  bounds, so the premature-out freeze fires (one sub-step an NFE, which
  keeps JAX's compile short): reward within 1e-4
  relative and the final bodies within 1e-4 of JAX's, and the gradient
  of the reward with respect to the throttle (autograd through the loop)
  within 2e-4 relative of ``jax.grad``;
* ``RoboCupJudge`` with its ``make_world_forward``, two sub-steps an NFE:
  the ball shot into the yellow goal ends the evaluation with the goal
  reward, at the same bars;
* four lander worlds in one batch, each with its own terrain, start and
  throttle (one world comes down onto its pad, one drifts out): each world's
  reward and final bodies against JAX's evaluate of that world alone.

JAX's evaluate is compiled once a case, with the terrain an argument.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_states import keys_np, state_dict

from parallax_tpu.envs import base as jbase
from parallax_tpu.envs import lunar_lander as jll
from parallax_tpu.envs import robocup as jrc
from parallax_tpu_torch.dynamics.bodies import BodyState
from parallax_tpu_torch.envs import lunar_lander as ll
from parallax_tpu_torch.envs import robocup as rc
from parallax_tpu_torch.envs.base import ConstantControl, Judge, PolicyControl, evaluate

torch.set_num_threads(2)
LANDER_EVAL = dict(eval_period=2.0, num_nfes=40, wfe_scale=1)
FIELDS = ("pos", "vel", "angle", "omega")


def _bodies(d, rows=slice(None)):
    return BodyState(*(torch.from_numpy(np.array(d[f"bodies.{f}"][rows])) for f in FIELDS))


def _jbodies(jlike, d, row):
    return jlike.replace(**{f: jnp.asarray(d[f"bodies.{f}"][row]) for f in FIELDS})


def _hold(got_r, want_r, got_b, want_b, what):
    np.testing.assert_allclose(float(got_r), float(want_r), rtol=1e-4, atol=0, err_msg=what)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got_b, f).detach().numpy(), np.asarray(getattr(want_b, f)),
                                   rtol=0, atol=1e-4, err_msg=f"{what} {f}")


@pytest.fixture(scope="module")
def lander():
    """The port's and JAX's landers, four reset states (own terrains) in a
    scene, and JAX's jitted evaluate of one world and its gradient."""
    env, jenv = ll.LunarLander(device="cpu"), jll.LunarLander()
    k = keys_np(4, 9)
    jst = jax.vmap(jenv.reset_fn)(jnp.asarray(k))
    d = state_dict(jst)
    pos, vel = d["bodies.pos"].copy(), d["bodies.vel"].copy()
    pos[0, :3, 0] += 13.0  # drifts out of bounds at x = 15
    vel[0, :3, 0] = 4.0
    pos[1, :3, 1] -= 6.0  # falls onto its pad
    vel[1, :3, 1] = -0.5
    d.update({"bodies.pos": pos, "bodies.vel": vel})
    jb0 = jax.tree_util.tree_map(lambda x: x[0], jst.bodies)

    def run(bodies, terrain, throttle):
        control = jbase.ConstantControl(jnp.stack([throttle, jnp.asarray(0.1)]))
        final, reward = jbase.evaluate(jll.make_world_forward(jenv, terrain), bodies, control,
                                       jll.LanderJudge(jenv, terrain), **LANDER_EVAL)
        return reward, final

    # ((reward, final), d reward / d throttle) in one compile
    jrun = jax.jit(jax.value_and_grad(run, argnums=2, has_aux=True))
    return env, d, jb0, jrun


def _port_eval(env, bodies, terrain, throttle):
    signal = torch.stack([throttle, torch.full_like(throttle, 0.1)], -1)
    return evaluate(ll.make_world_forward(env, terrain), bodies, ConstantControl(signal),
                    ll.LanderJudge(env, terrain), **LANDER_EVAL)


def test_toy_evaluate_matches_jax():
    """x' = u with u = 1, reward x, done at x >= 1 with +10: x freezes at 1
    at t = 1 and the reward is 0.5 + 10 (``test_envs.py``'s bounds)."""

    class XJudge(Judge):
        def reward(self, state, u):
            return state

        def is_done(self, state, u):
            return state >= 1.0

        def end_reward(self, state, u):
            return torch.where(state >= 1.0, 10.0, 0.0)

    class JXJudge(jbase.Judge):
        def reward(self, state, u):
            return state

        def is_done(self, state, u):
            return state >= 1.0

        def end_reward(self, state, u):
            return jnp.where(state >= 1.0, 10.0, 0.0)

    kw = dict(eval_period=2.0, num_nfes=20, wfe_scale=10)
    final, reward = evaluate(lambda s, u, dt: s + u * dt, torch.tensor(0.0),
                             ConstantControl(torch.tensor(1.0)), XJudge(), **kw)
    jfinal, jreward = jbase.evaluate(lambda s, u, dt: s + u * dt, jnp.asarray(0.0),
                                     jbase.ConstantControl(jnp.asarray(1.0)), JXJudge(), **kw)
    assert abs(float(final) - 1.0) < 0.05 and 10.0 < float(reward) < 11.0
    np.testing.assert_allclose(float(final), float(jfinal), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(reward), float(jreward), rtol=0, atol=1e-6)
    # a policy held once an NFE that answers 1 is the constant control
    pfinal, preward = evaluate(lambda s, u, dt: s + u * dt, torch.tensor(0.0),
                               PolicyControl(lambda p, obs: p, torch.tensor(1.0), lambda s: s),
                               XJudge(), **kw)
    assert float(pfinal) == float(final) and float(preward) == float(reward)


def test_lander_evaluate_and_gradient_match_jax(lander):
    env, d, jb0, jrun = lander
    terrain = torch.from_numpy(d["terrain"][0].copy())
    throttle = torch.tensor(0.25, requires_grad=True)
    final, reward = _port_eval(env, _bodies(d, 0), terrain, throttle)
    (jreward, jfinal), jg = jrun(_jbodies(jb0, d, 0), jnp.asarray(d["terrain"][0]),
                                 jnp.float32(0.25))
    _hold(reward.detach(), jreward, final, jfinal, "lander")
    assert float(reward.detach()) < -50.0  # the crash's end reward is in
    assert abs(float(final.pos[0, 0].detach())) > env.config.out_x  # frozen past the bound
    reward.backward()
    jg = float(jg)
    assert np.isfinite(float(throttle.grad)) and jg != 0.0
    np.testing.assert_allclose(float(throttle.grad), jg, rtol=2e-4, atol=0)


def test_robocup_judge_matches_jax():
    env, jenv = rc.RoboCup(device="cpu"), jrc.RoboCup()
    jb = jenv.reset_fn(jax.random.PRNGKey(0)).bodies
    pos = np.asarray(jb.pos).copy()
    vel = np.asarray(jb.vel).copy()
    pos[env.ball_idx], vel[env.ball_idx] = (-4.0, 0.1), (-3.0, 0.0)
    jb = jb.replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    bodies = BodyState(*(torch.from_numpy(np.asarray(getattr(jb, f)).copy()) for f in FIELDS))
    signal = np.random.default_rng(0).uniform(-1, 1, env.action_size).astype(np.float32)
    kw = dict(eval_period=0.6, num_nfes=6, wfe_scale=2)
    final, reward = evaluate(rc.make_world_forward(env), bodies,
                             ConstantControl(torch.from_numpy(signal)), rc.RoboCupJudge(env), **kw)
    jfinal, jreward = jax.jit(lambda b: jbase.evaluate(
        jrc.make_world_forward(jenv), b, jbase.ConstantControl(jnp.asarray(signal)),
        jrc.RoboCupJudge(jenv), **kw))(jb)
    _hold(reward, jreward, final, jfinal, "robocup")
    assert float(reward) > 0.9  # blue scored: the goal reward ended it


def test_four_worlds_own_terrains_in_one_batch(lander):
    env, d, jb0, jrun = lander
    throttles = np.float32([0.25, 0.5, 0.0, 0.9])
    with torch.no_grad():
        final, reward = _port_eval(env, _bodies(d), torch.from_numpy(d["terrain"].copy()),
                                   torch.from_numpy(throttles))
    assert reward.shape == (4,) and final.pos.shape == (4, 4, 2)
    for w in range(4):
        (jreward, jfinal), _ = jrun(_jbodies(jb0, d, w), jnp.asarray(d["terrain"][w]),
                                    jnp.float32(throttles[w]))
        got = BodyState(*(x[w] for x in final))
        _hold(reward[w], jreward, got, jfinal, f"world {w}")
    assert float(reward[0]) < -50.0 and abs(float(final.pos[0, 0, 0])) > env.config.out_x
