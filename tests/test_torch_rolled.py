"""The port's offset-rolled billiards physics (``engine/rolled.py``) on the CPU.

``BilliardsConfig(rolled=True)`` steps the balls with static rolls of the
``[n_balls, B]`` planes in place of the lane table.  It is held against
the JAX package's ``physics_rolled`` and its rolled env, and against the
port's own lane engine (as ``tests/test_rolled.py`` holds JAX's).  The
states are ``tests/test_rolled.py``'s scattered tables
(``torch_scenarios.billiards_scatter``: every lane family populated),
drawn with numpy, all at B=64 (JAX's eager ops compile once per shape).  JAX's rolled step and rollout run eagerly (``jax.disable_jit``
for the rollout's scan): XLA's CPU compile of the unrolled offsets takes
minutes, the eager run seconds.  Tolerances:

* one step, against JAX: atol 1e-5 (the same formulas in the same order;
  the frameworks round a few operations differently);
* the VJP of one step against ``jax.vjp``: rtol 2e-4, atol 1e-5, the bar
  the JAX package sets between two reverse passes of its step;
* a 30-step rolled rollout against JAX's: obs and reward atol 1e-4, the
  flags equal, as for the other envs' rollouts;
* rolled against the lane engine: atol 2e-5, ``tests/test_rolled.py``'s
  bar (the same per-iteration math, the Jacobi sums reassociated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.engine import batched as jb
from parallax_tpu.engine import rolled as jrolled
from parallax_tpu.envs.billiards import Billiards as JaxBilliards
from parallax_tpu.envs.billiards import BilliardsConfig as JaxBilliardsConfig
from parallax_tpu_torch.engine import rolled
from parallax_tpu_torch.engine.batched import physics_core
from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
from parallax_tpu_torch.utils import convert
from torch_jax_states import jax_state, keys_np, np_tree, port_keys
from torch_scenarios import billiards_scatter

torch.set_num_threads(2)

B = 64
FIELDS = ("px", "py", "vx", "vy", "angle", "omega")


def to_jax(s):
    return jb._SoA(*(jnp.asarray(x.detach().numpy()) for x in s))


def hold_planes(got, want, atol, rtol=0.0, what=""):
    for f, g, w in zip(FIELDS, got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=atol, rtol=rtol,
                                   err_msg=f"{what} {f}")


@pytest.mark.parametrize("n_object", [7, 8])  # nb = 8 (offset 4 half-masked) and 9
def test_physics_rolled_matches_jax(n_object):
    env = Billiards(BilliardsConfig(n_object=n_object, rolled=True), device="cpu")
    jenv = JaxBilliards(JaxBilliardsConfig(n_object=n_object, rolled=True))
    s = billiards_scatter(env, B, n_object)
    got, con = rolled.physics_rolled(env._rolled_world, s)
    want, _ = jrolled.physics_rolled(jenv._rolled_world, to_jax(s))
    hold_planes(got, want, 1e-5, what=f"n_object={n_object}")
    assert con.active.shape == (0, B) and con.pen_x.shape == (0, B)
    # the scenario moves balls by contact: the step is not a free flight
    free = s.px[: env.n_balls] + s.vx[: env.n_balls] * env.config.dt
    assert (got.vx[: env.n_balls] != s.vx[: env.n_balls]).any()
    assert (got.px[: env.n_balls] - free).abs().max() > 1e-4
    # the walls are carried through untouched
    for g, x in zip(got, s):
        assert torch.equal(g[env.n_balls:], x[env.n_balls:])


def test_rolled_vjp_matches_jax():
    """The VJP of one rolled step against ``jax.vjp``, with the cue driven
    into ball 1 in every world (a contact that is approaching and deep)."""
    env = Billiards(BilliardsConfig(n_object=7, rolled=True), device="cpu")
    jenv = JaxBilliards(JaxBilliardsConfig(n_object=7, rolled=True))
    s = billiards_scatter(env, B, 9, speed=2.0)
    px, py, vx, vy = (x.clone() for x in (s.px, s.py, s.vx, s.vy))
    px[0], px[1], py[0], py[1] = 0.0, 0.07, 0.0, 0.0
    vx[0], vx[1], vy[0], vy[1] = 1.0, 0.0, 0.0, 0.0
    s = s._replace(px=px, py=py, vx=vx, vy=vy)
    rng = np.random.default_rng(3)
    cot = [rng.standard_normal(tuple(s.px.shape)).astype(np.float32) for _ in FIELDS]

    leaves = [x.clone().requires_grad_(True) for x in s]
    out, _ = rolled.physics_rolled(env._rolled_world, type(s)(*leaves))
    got = torch.autograd.grad(list(out), leaves, [torch.from_numpy(c) for c in cot])
    _, vjp = jax.vjp(lambda x: jrolled.physics_rolled(jenv._rolled_world, x)[0], to_jax(s))
    (want,) = vjp(jb._SoA(*(jnp.asarray(c) for c in cot)))
    hold_planes(got, want, 1e-5, rtol=2e-4, what="VJP")
    assert got[2][1].abs().max() > 0.1  # ball 1's vx feels the contact


def test_rolled_rollout_matches_jax():
    """30 env steps of the rolled table (pre, physics, post, pots and
    auto-resets) against JAX's rolled env from the same scattered states;
    three object balls (nb = 4, offset 2 half-masked) keep JAX's eager
    rollout short."""
    T = 30
    env = Billiards(BilliardsConfig(n_object=3, rolled=True), device="cpu")
    jenv = JaxBilliards(JaxBilliardsConfig(n_object=3, rolled=True))
    st = env.reset_fn_batch(port_keys(keys_np(B, 3)))
    s = billiards_scatter(env, B, 3)
    st = st._replace(bodies=st.bodies._replace(
        pos=torch.stack([s.px.T, s.py.T], -1), vel=torch.stack([s.vx.T, s.vy.T], -1)))
    actions = np.random.default_rng(4).uniform(-1, 1, (B, 2)).astype(np.float32)

    def pol(_, obs):
        return torch.from_numpy(actions)

    def jpol(_, obs):
        return jnp.asarray(actions)

    jst = jax_state(jenv.reset_fn_batch(jnp.zeros((B, 2), jnp.uint32)),
                    convert.billiards_state_to_numpy(st))
    fin, traj = env.rollout_batch(st, pol, T)
    with jax.disable_jit():  # XLA's compile of the unrolled offsets takes minutes
        jfin, jtraj = jenv.rollout_batch(jst, jpol, T)
    got, want = np_tree(traj), np_tree(jtraj)
    assert traj.done.any(), "no pot and reset in the window"
    for k in ("obs", "reward"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0, err_msg=k)
    for k in ("terminated", "truncated", "info.cue_lost", "info.cleared"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(fin.potted.numpy(), np.asarray(jfin.potted))


@pytest.mark.parametrize("n_object", [6, 7])  # nb = 7 (all offsets whole) and 8
def test_rolled_matches_lane_engine(n_object):
    env = Billiards(BilliardsConfig(n_object=n_object, rolled=True), device="cpu")
    s = billiards_scatter(env, B, n_object)
    want, con = physics_core(env.world, s)
    got, _ = rolled.physics_rolled(env._rolled_world, s)
    hold_planes(got, want, 2e-5, what=f"n_object={n_object}")
    assert int(con.active.sum()) > B // 4  # the scenario has contacts
    # the env's batched step takes the rolled path
    st = env.reset_fn_batch(port_keys(keys_np(4, 1)))
    lane_env = Billiards(BilliardsConfig(n_object=n_object), device="cpu")
    acts = torch.full((4, 2), 0.5)
    a, _ = env.step_batch(st, acts)
    b, _ = lane_env.step_batch(st, acts)
    np.testing.assert_allclose(a.bodies.pos.numpy(), b.bodies.pos.numpy(), atol=2e-5)
