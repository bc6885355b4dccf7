"""The port's plane-space ``PlaneEnvMixin.step_fn_batch`` against the JAX
package's, on the four envs and on rolled billiards.

``step_fn_batch`` is the raw plane step: pre, physics, post and obs, with
``truncated`` the step limit alone, the key unchanged, and no watchdog
and no auto-reset.  Each case starts from the port's states a few steps
into a rollout (``reset_fn_batch``, then three ``step_batch`` steps with
seeded actions), displaced so that contacts, landings, crashes and goals
happen, with some worlds at ``t = max_steps - 1`` so that the limit and
its ``& ~terminated`` both show.  The same states, as numpy, go through
both packages.  Bars, each with its reason:

* the per-world API's bars (``PERF.md`` §2, ``tests/test_torch_env_step_
  lander.py``): positions and angles 1e-5, velocities and angular
  velocities 1e-4, reward, obs and ``prev_shaping`` 1e-5; the terrain,
  the flags, ``t`` and the key exact;
* rolled billiards at ``tests/test_torch_rolled.py``'s one-step bar: 1e-5
  on every plane.

A reference-mode RoboCup (``narrowphase="gjk_epa"``,
``solver_mode="random_one_per_body"``) is refused with ``ValueError`` by
both packages.  One lander world's terrain poisoned with NaN: JAX's
``step_batch`` (``BatchedEnvironmentMixin``'s, its watchdog over the whole
state of ``step_fn_batch``) and the port's (the rollout's own step) flag,
zero and reset the same worlds.

Each env's JAX reference is one jitted function, compiled once in a
module-scoped fixture; JAX's rolled step runs eagerly (``jax.disable_jit``),
as in ``tests/test_torch_rolled.py``: XLA's CPU compile of the unrolled
offsets takes minutes.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_states import hold, jax_state_of, keys_np, np_tree, port_keys, state_dict
from torch_scenarios import billiards_scatter, env_actions, overlap_state

from parallax_tpu.envs import billiards as jbilliards
from parallax_tpu.envs import bouncer as jbouncer
from parallax_tpu.envs import lunar_lander as jlander
from parallax_tpu.envs import robocup as jrobocup
from parallax_tpu_torch.engine.batched import _from_soa
from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
from parallax_tpu_torch.envs.bouncer import Bouncer
from parallax_tpu_torch.envs.lunar_lander import LunarLander
from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig
from parallax_tpu_torch.utils import convert

torch.set_num_threads(2)
B = 8
BARS = {"bodies.pos": 1e-5, "bodies.vel": 1e-4, "bodies.angle": 1e-5, "bodies.omega": 1e-4,
        "prev_shaping": 1e-5}
TS_BARS = {"reward": 1e-5, "obs": 1e-5, "info.ball_speed": 1e-4}
ROLLED_BAR = 1e-5
POISONED = 5  # the lander world whose terrain is NaN

# name -> (port env, JAX env, JAX state class, the port state to and from numpy)
ENVS = {
    "lander": (lambda: LunarLander(device="cpu"), jlander.LunarLander, jlander.LanderState,
               convert.lander_state_to_numpy, convert.lander_state_from_numpy),
    "robocup": (lambda: RoboCup(device="cpu"), jrobocup.RoboCup, jrobocup.RoboCupState,
                convert.robocup_state_to_numpy, convert.robocup_state_from_numpy),
    "bouncer": (lambda: Bouncer(device="cpu"), jbouncer.Bouncer, jbouncer.BouncerState,
                convert.bouncer_state_to_numpy, convert.bouncer_state_from_numpy),
    "billiards": (lambda: Billiards(device="cpu"), jbilliards.Billiards,
                  jbilliards.BilliardsState, convert.billiards_state_to_numpy,
                  convert.billiards_state_from_numpy),
}


def displace(name, env, st):
    """Contacts and episode ends: the lander by world mod 4 as
    ``torch_scenarios.lander_scene`` (0 sliding on its pad, 1 set down on
    it, 2 out of bounds, 3 free flight); RoboCup by world mod 2 as
    ``robocup_scene`` (0 the ball flying into the yellow goal, 1 two robots
    side by side); the bouncer's balls piled at the box's edge
    (``overlap_state``) and billiards' scattered over the table
    (``billiards_scatter``), so that ball-ball and ball-wall lanes fire."""
    pos, vel = st.bodies.pos.clone(), st.bodies.vel.clone()
    w = torch.arange(B)
    if name == "lander":
        pos[w % 4 == 0, :3, 1] -= 6.25
        vel[w % 4 == 0, :3, 0] += 0.2
        pos[w % 4 == 1, :3, 1] -= 6.2
        pos[w % 4 == 2, :3, 0] += 16.0
    elif name == "robocup":
        bi, r0, N = env.ball_idx, int(env.robot_idx[0]), env.config.n_robots_per_team
        goal = w % 2 == 0
        pos[goal, bi] = torch.tensor([-4.55, 0.0])
        vel[goal, bi] = torch.tensor([-3.0, 0.0])
        pos[~goal, r0] = pos[~goal, r0 + N] + torch.tensor([0.15, 0.0])
    else:
        s = (overlap_state(env, B, 0, 2.0, 0.25, 0.1) if name == "bouncer"
             else billiards_scatter(env, B, 9))
        pos, vel = _from_soa(s)[:2]
    return st._replace(bodies=st.bodies._replace(pos=pos, vel=vel))


def start(name, env, to_np):
    """The port's states three steps into a rollout, displaced, worlds 0, 2
    and 3 at ``max_steps - 1`` (the lander's world 2 crashes and RoboCup's
    world 2 scores, so there the limit is masked by ``~terminated``); as
    numpy."""
    st = env.reset_fn_batch(port_keys(keys_np(B, 1)))
    for a in env_actions(env, 3, B, seed=2):
        st, _ = env.step_batch(st, a)
    st = displace(name, env, st)
    t = st.t.clone()
    t[[0, 2, 3]] = env.config.max_steps - 1
    return to_np(st._replace(t=t))


def as_np(to_np, state, ts):
    """A state and its TimeStep as numpy dicts (``to_np``: the state's)."""
    return to_np(state), np_tree(ts)


class RecordingLander(jlander.LunarLander):
    """JAX's lander that keeps its last raw ``step_fn_batch`` output, so one
    jitted ``step_batch`` gives both (one compile for the lander)."""

    def step_fn_batch(self, states, actions):
        self.raw = super().step_fn_batch(states, actions)
        return self.raw


def run_case(name):
    """``(port env, start dict, port results, JAX results)`` of one
    ``step_fn_batch``; the lander's also ``(port, JAX, poisoned start)`` of
    one ``step_batch`` from its start with world ``POISONED``'s terrain
    NaN: JAX steps the clean and the poisoned fleet as one batch of 2B
    (worlds are independent), and its ``step_fn_batch`` output is read
    inside its ``step_batch``."""
    make, jcls, jstate, to_np, from_np = ENVS[name]
    env = make()
    d = start(name, env, to_np)
    a = env_actions(env, 1, B, seed=3)[0]
    got = as_np(to_np, *env.step_fn_batch(from_np(d, "cpu"), a))
    if name != "lander":
        want = jax.jit(jcls().step_fn_batch)(jax_state_of(jstate, d), a.numpy())
        return env, d, got, as_np(state_dict, *want)
    dp = dict(d, terrain=d["terrain"].copy())
    dp["terrain"][POISONED, 3] = np.nan
    both = {k: np.concatenate([d[k], dp[k]]) for k in d}
    jenv = RecordingLander()
    stepped, raw = jax.jit(lambda s, a: (jenv.step_batch(s, a), jenv.raw))(
        jax_state_of(jstate, both), np.concatenate([a.numpy()] * 2))

    def half(tree, sl):
        return as_np(state_dict, *jax.tree.map(lambda x: x[sl], tree))

    poison = (as_np(to_np, *env.step_batch(from_np(dp, "cpu"), a)),
              half(stepped, slice(B, 2 * B)), dp)
    return env, d, got, half(raw, slice(0, B)), poison


def run_rolled():
    """``BilliardsConfig(rolled=True)`` from billiards' start: ``(port, JAX)``,
    JAX's step eager."""
    to_np = convert.billiards_state_to_numpy
    d = start("billiards", Billiards(device="cpu"), to_np)
    env = Billiards(BilliardsConfig(rolled=True), device="cpu")
    a = env_actions(env, 1, B, seed=3)[0]
    got = as_np(to_np, *env.step_fn_batch(convert.billiards_state_from_numpy(d, "cpu"), a))
    jenv = jbilliards.Billiards(jbilliards.BilliardsConfig(rolled=True))
    with jax.disable_jit():
        want = jenv.step_fn_batch(jax_state_of(jbilliards.BilliardsState, d), a.numpy())
    return got, as_np(state_dict, *want)


@pytest.fixture(scope="module")
def cases():
    """name -> :func:`run_case`'s results (``"rolled"``: :func:`run_rolled`'s).
    The cases run in threads, so that XLA's compiles (which release the
    GIL) overlap: one compile an env, about 4-8 s each on the CPU."""
    runs = dict.fromkeys(ENVS, run_case)
    runs["rolled"] = lambda _: run_rolled()
    with ThreadPoolExecutor(len(runs)) as pool:
        futures = {name: pool.submit(run, name) for name, run in runs.items()}
        return {name: f.result() for name, f in futures.items()}


@pytest.mark.parametrize("name", ["lander", "robocup", "bouncer"])
def test_step_fn_batch_matches_jax(cases, name):
    env, d, (gs, gts), (ws, wts) = cases[name][:4]
    hold(gs, ws, BARS, what=f"{name} state")
    hold(gts, wts, TS_BARS, what=f"{name} TimeStep")
    # the raw step: the key unchanged, t stepped, the limit alone in truncated
    np.testing.assert_array_equal(gs["key"], d["key"])
    np.testing.assert_array_equal(gs["t"], d["t"] + 1)
    limit = d["t"] + 1 >= env.plane_max_steps
    np.testing.assert_array_equal(gts["truncated"], limit & ~gts["terminated"])
    assert gts["truncated"][3]
    if name != "bouncer":  # the lander crashes and RoboCup scores in world 2
        assert gts["terminated"][2] and not gts["truncated"][2]
    if name == "lander":
        assert gts["info.leg_contacts"].any()


def test_billiards_step_fn_batch_matches_jax(cases):
    """The lane engine at the per-world bars, and ``BilliardsConfig(rolled=
    True)`` (``engine/rolled.py``) at the rolled bar, both against JAX."""
    env, d, (gs, gts), (ws, wts) = cases["billiards"]
    hold(gs, ws, BARS, what="billiards state")
    hold(gts, wts, TS_BARS, what="billiards TimeStep")
    limit = d["t"] + 1 >= env.plane_max_steps
    np.testing.assert_array_equal(gts["truncated"], limit & ~gts["terminated"])
    assert (gs["bodies.vel"] != d["bodies.vel"]).any(axis=-1).sum() > B  # collisions
    (gs, gts), (ws, wts) = cases["rolled"]
    hold(gs, ws, dict.fromkeys(BARS, ROLLED_BAR), what="rolled billiards state")
    hold(gts, wts, {"reward": ROLLED_BAR, "obs": ROLLED_BAR}, what="rolled billiards TimeStep")
    np.testing.assert_array_equal(gs["key"], d["key"])


def test_reference_mode_robocup_refused_by_both():
    """``physics_core`` refuses the per-world reference modes in both
    packages: ``step_fn_batch`` raises ``ValueError`` and never falls back
    to the per-world ``step_fn``."""
    cfg = dict(narrowphase="gjk_epa", solver_mode="random_one_per_body")
    env = RoboCup(RoboCupConfig(**cfg), device="cpu")
    jenv = jrobocup.RoboCup(jrobocup.RoboCupConfig(**cfg))
    st = env.reset_fn_batch(port_keys(keys_np(2, 7)))
    a = torch.full((2, env.action_size), 0.5)
    with pytest.raises(ValueError, match="gjk_epa"):
        env.step_fn_batch(st, a)
    js = jax_state_of(jrobocup.RoboCupState, convert.robocup_state_to_numpy(st))
    with pytest.raises(ValueError, match="gjk_epa"):
        jenv.step_fn_batch(js, jnp.asarray(a.numpy()))


def test_poisoned_terrain_flagged_like_jax(cases):
    """World ``POISONED``'s terrain holds a NaN: JAX's ``step_batch`` over
    ``step_fn_batch`` and the port's ``step_batch`` truncate, zero and
    reset the same worlds, and every other world steps as in JAX."""
    (gs, gts), (ws, wts), dp = cases["lander"][4]
    hold(gs, ws, BARS, what="poisoned state")
    hold(gts, wts, TS_BARS, what="poisoned TimeStep")
    assert gts["truncated"][POISONED] and gts["reward"][POISONED] == 0.0
    assert (gts["obs"][POISONED] == 0.0).all()
    assert np.isfinite(gs["terrain"]).all() and gs["t"][POISONED] == 0
    assert not np.array_equal(gs["terrain"][POISONED], dp["terrain"][POISONED])
