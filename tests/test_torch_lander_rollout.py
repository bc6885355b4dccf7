"""The port's LunarLander rollout against the JAX package's, step for step.

Same start states (from the same numpy-made keys, or the lowered start of
``tests/test_pallas_solver.py``), same policy weights (numpy, seeded), 72
steps at B=128: the lowered lander's hull reaches the ground around step
65, so the comparison covers crashes and their auto-resets.  obs and
reward must agree within atol 1e-4: float32 rounding differs between the
frameworks (XLA fuses multiply-adds, sums in another order) and grows
over 72 contact steps, while 1e-4 stays far below any change of a
contact decision.  Termination, truncation and the final PRNG keys must
be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.dynamics.bodies import BodyState as JaxBodyState
from parallax_tpu.envs.lunar_lander import LanderState as JaxLanderState
from parallax_tpu.envs.lunar_lander import LunarLander as JaxLander
from parallax_tpu_torch.envs.lunar_lander import LunarLander
from parallax_tpu_torch.parallel import rollout as trollout
from parallax_tpu_torch.utils import convert

torch.set_num_threads(2)

B = 128
STEPS = 72
ATOL = 1e-4


def _policy_weights(kind):
    rng = np.random.default_rng(11)
    W = (rng.standard_normal((9, 2)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(2) * 0.3).astype(np.float32)
    # tanh(0) == 0 exactly: the zero policy shares the linear one's program
    return (W * 0, b * 0) if kind == "zero" else (W, b)


def torch_policy(params, obs):
    return torch.tanh(obs @ params[0] + params[1])


def jax_policy(params, obs):
    return jnp.tanh(obs @ params[0] + params[1])


def start_state(env, start):
    keys = np.random.default_rng(3).integers(0, 2**32, (B, 2), dtype=np.uint32)
    st = env.reset_fn_batch(torch.from_numpy(keys.astype(np.int64)))
    if start == "lowered":
        b = st.bodies
        st = st._replace(bodies=b._replace(
            pos=b.pos - torch.tensor([0.0, 6.2]), vel=b.vel - torch.tensor([0.0, 0.6])
        ))
    return st


def to_jax(st):
    d = convert.lander_state_to_numpy(st)
    return JaxLanderState(
        bodies=JaxBodyState(
            pos=jnp.asarray(d["bodies.pos"]), vel=jnp.asarray(d["bodies.vel"]),
            angle=jnp.asarray(d["bodies.angle"]), omega=jnp.asarray(d["bodies.omega"]),
        ),
        terrain=jnp.asarray(d["terrain"]),
        t=jnp.asarray(d["t"]),
        key=jnp.asarray(d["key"]),
        prev_shaping=jnp.asarray(d["prev_shaping"]),
        leg_contacts=jnp.asarray(d["leg_contacts"]),
    )


@pytest.fixture(scope="module")
def envs():
    jenv = JaxLander()
    run = jax.jit(lambda s, p: jenv.rollout_batch(s, jax_policy, STEPS, p))
    return LunarLander(device="cpu"), run


def _compare(got_final, got_traj, want_final, want_traj):
    np.testing.assert_allclose(
        got_traj.obs.numpy(), np.asarray(want_traj.obs), atol=ATOL, rtol=0
    )
    np.testing.assert_allclose(
        got_traj.reward.numpy(), np.asarray(want_traj.reward), atol=ATOL, rtol=0
    )
    for f in ("terminated", "truncated"):
        np.testing.assert_array_equal(
            getattr(got_traj, f).numpy(), np.asarray(getattr(want_traj, f)), f
        )
    np.testing.assert_array_equal(
        got_traj.info["leg_contacts"].numpy(), np.asarray(want_traj.info["leg_contacts"])
    )
    np.testing.assert_array_equal(
        got_final.key.numpy(), np.asarray(want_final.key).astype(np.int64)
    )
    np.testing.assert_array_equal(got_final.t.numpy(), np.asarray(want_final.t))
    np.testing.assert_array_equal(
        got_final.terrain.numpy(), np.asarray(want_final.terrain)
    )


@pytest.mark.parametrize("start", ["reset", "lowered"])
@pytest.mark.parametrize("policy", ["zero", "tanh_linear"])
def test_rollout_matches_jax(envs, start, policy):
    env, jax_run = envs
    W, b = _policy_weights(policy)
    st = start_state(env, start)
    got_final, got = env.rollout_batch(
        st, torch_policy, STEPS, (torch.from_numpy(W), torch.from_numpy(b))
    )
    want_final, want = jax_run(to_jax(st), (jnp.asarray(W), jnp.asarray(b)))
    _compare(got_final, got, want_final, want)
    assert got.obs.shape == (STEPS, B, 9)
    assert np.isfinite(got.obs.numpy()).all()
    if start == "lowered":
        assert got.info["leg_contacts"].numpy().any()
        if policy == "zero":
            assert got.terminated.numpy().any(), "the unpowered lander must crash"


def test_nan_world_is_truncated_and_reset(envs):
    env, jax_run = envs
    W, b = _policy_weights("tanh_linear")
    params = (torch.from_numpy(W), torch.from_numpy(b))
    clean = start_state(env, "reset")
    bad = 5
    vel = clean.bodies.vel.clone()
    vel[bad, 0, 0] = float("nan")
    poisoned = clean._replace(bodies=clean.bodies._replace(vel=vel))

    got_final, got = env.rollout_batch(poisoned, torch_policy, STEPS, params)
    ref_final, ref = env.rollout_batch(clean, torch_policy, STEPS, params)

    tr = got.truncated.numpy()
    assert tr[0, bad] and tr[0].sum() == 1
    assert got.reward.numpy()[0, bad] == 0.0
    assert (got.obs.numpy()[0, bad] == 0.0).all()
    assert np.isfinite(got.obs.numpy()).all()
    assert np.isfinite(got_final.bodies.pos.numpy()).all()
    others = np.arange(B) != bad
    for f in ("obs", "reward", "terminated", "truncated"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy()[:, others], getattr(ref, f).numpy()[:, others], f
        )
    # the reset world restarts at the spawn pose with t counting from 0
    np.testing.assert_array_equal(got_final.t.numpy()[bad], STEPS - 1)
    want_final, want = jax_run(to_jax(poisoned), (jnp.asarray(W), jnp.asarray(b)))
    _compare(got_final, got, want_final, want)


def test_chunked_waves_match_one_wave(envs):
    env, _ = envs
    W, b = _policy_weights("tanh_linear")
    params = (torch.from_numpy(W), torch.from_numpy(b))
    st = start_state(env, "lowered")
    one_final, one = env.rollout_batch(st, torch_policy, 20, params, max_chunk=0)
    w_final, waves = env.rollout_batch(st, torch_policy, 20, params, max_chunk=48)
    assert trollout.ROLLOUT_CHUNK == 8192
    np.testing.assert_allclose(waves.obs.numpy(), one.obs.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(waves.terminated.numpy(), one.terminated.numpy())
    np.testing.assert_array_equal(w_final.key.numpy(), one_final.key.numpy())


def test_state_numpy_round_trip(envs):
    env, _ = envs
    st = start_state(env, "lowered")
    back = convert.lander_state_from_numpy(convert.lander_state_to_numpy(st), device="cpu")
    for a, b in zip(
        list(back.bodies) + list(back[1:]), list(st.bodies) + list(st[1:])
    ):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_mesh_takes_a_world_mesh_and_remat_keeps_values(envs):
    """``mesh=`` takes a world mesh (a one-rank gloo mesh here: the same
    rollout as without it) and refuses anything else; ``remat_steps``
    changes no value of a forward rollout."""
    from parallax_tpu_torch.parallel.mesh import make_world_mesh

    env, _ = envs
    st = start_state(env, "reset")
    W, b = _policy_weights("tanh_linear")
    params = (torch.from_numpy(W), torch.from_numpy(b))
    with pytest.raises(TypeError, match="DeviceMesh"):
        env.rollout_batch(st, torch_policy, 1, None, mesh=object())
    mesh = make_world_mesh("cpu")
    try:
        _, on_mesh = env.rollout_batch(st, torch_policy, 3, params, max_chunk=50, mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
    _, alone = env.rollout_batch(st, torch_policy, 3, params, max_chunk=50)
    assert torch.equal(on_mesh.obs, alone.obs) and torch.equal(on_mesh.reward, alone.reward)
    _, remat = env.rollout_batch(st, torch_policy, 3, params, remat_steps=True)
    _, plain = env.rollout_batch(st, torch_policy, 3, params)
    assert torch.equal(remat.obs, plain.obs) and torch.equal(remat.reward, plain.reward)

