"""The port's fleet against the JAX package's mesh, on the CPU.

Four gloo ranks of the port (``tests/torch_fleet_worker.py``, no jax)
run the workloads of ``tests/test_parallel.py`` that JAX runs on the
conftest's 8-device CPU mesh, on the same worlds (the port's
``utils/prng.py`` draws JAX's keys, and the start states are checked
against JAX's to the bit through ``utils/convert.py``'s dicts):

* (e) the mesh-chunked lander rollout of 64 worlds, 12 steps: JAX at 8
  worlds a device and chunk 4 (two waves a device), the port at 16 a rank
  and chunk 5 (3 full waves and a remainder of 1).  Bars as
  ``test_parallel.py:231`` sets them between JAX's own mesh and
  one-device runs: pos and vel 5e-7, reward and obs 1e-6 absolute, the
  flags equal;
* (f) the mesh-chunked train step of ``test_parallel.py:288`` (4 steps,
  zero weights, SGD at 1e-2) on the same 64 worlds: JAX at chunk 4 over 8
  devices (two waves a device), the port at 16 worlds a rank and chunk 5
  (3 waves and a remainder of 1, under the gradient).  Bars as
  ``tests/test_torch_train.py`` sets them: the loss 1e-5 relative, each
  gradient 1e-4 relative in norm;
* (g) ``parallel/dryrun.py:dryrun_multichip`` on the four ranks.

JAX's two programs have whole waves only: a remainder wave would compile
the step a second time.  The ranks run while JAX compiles, so the file's
time is about the longer of the two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from parallax_tpu.envs.lunar_lander import LunarLander as JaxLander
from parallax_tpu.parallel.mesh import make_world_mesh, replicated, shard_batch
from parallax_tpu.parallel.rollout import make_train_step
from torch_fleet_worker import CONST_ACTION, FLEET_STEPS, JAX_FLEET_B, Fleet
from torch_jax_states import hold, state_dict

RANKS = 4
LR = 1e-2
ROLLOUT_BARS = {"pos": 5e-7, "vel": 5e-7, "reward": 1e-6, "obs": 1e-6}


def _policy(_, obs):
    return jnp.tile(jnp.array(CONST_ACTION), (obs.shape[0], 1))


def _linear(p, obs):
    return jnp.tanh(obs @ p["w"] + p["b"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    fleet = Fleet(tmp_path_factory.mktemp("fleet_jax"), RANKS,
                  ("jax_rollout", "jax_train", "dryrun"))
    mesh = make_world_mesh()
    env = JaxLander()

    states = env.reset_fn_batch(jax.random.split(jax.random.PRNGKey(1), JAX_FLEET_B))
    final, traj = jax.jit(
        lambda s: env.rollout_batch(s, _policy, FLEET_STEPS, max_chunk=4, mesh=mesh)
    )(shard_batch(states, mesh))
    rollout = {"start": state_dict(states), "pos": np.asarray(final.bodies.pos),
               "vel": np.asarray(final.bodies.vel), "reward": np.asarray(traj.reward),
               "obs": np.asarray(traj.obs), "terminated": np.asarray(traj.terminated),
               "truncated": np.asarray(traj.truncated)}

    params = {"w": jnp.zeros((9, 2)), "b": jnp.zeros(2)}
    optimizer = optax.sgd(LR)
    tstates = env.reset_fn_batch(jax.random.split(jax.random.PRNGKey(2), JAX_FLEET_B))
    step = make_train_step(env, _linear, optimizer, 4, max_chunk=4, mesh=mesh)
    new, _, _, metrics = jax.jit(step)(
        jax.device_put(params, replicated(mesh)),
        jax.device_put(optimizer.init(params), replicated(mesh)),
        shard_batch(tstates, mesh),
    )
    # SGD from zero weights: the step is -lr * grad
    train = {"start": state_dict(tstates), "loss": float(metrics["loss"]),
             "grads": {k: -np.asarray(v) / LR for k, v in new.items()}}
    return fleet.results(), rollout, train


def _start(got: dict) -> dict:
    return {k[len("start."):]: v for k, v in got.items() if k.startswith("start.")}


def test_mesh_rollout_matches_jax_mesh(runs):
    """(e): the same 64 worlds from the same keys, 12 steps, both meshes."""
    results, want, _ = runs
    got = results["jax_rollout"][0]
    hold(_start(got), want["start"], {}, what="start states")
    hold({k: got[k] for k in ROLLOUT_BARS}, {k: want[k] for k in ROLLOUT_BARS}, ROLLOUT_BARS,
         what="port 4 ranks vs JAX 8 devices")
    for flag in ("terminated", "truncated"):
        np.testing.assert_array_equal(got[flag], want[flag], err_msg=flag)
    for other in results["jax_rollout"][1:]:  # gather_batch gives every rank the whole fleet
        for k, v in got.items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_mesh_train_step_matches_jax_mesh(runs):
    """(f): loss and gradients of the chunked train step under the mesh."""
    results, _, want = runs
    hold(_start(results["jax_train"][0]), want["start"], {}, what="start states")
    for got in results["jax_train"]:
        assert abs(float(got["loss"]) - want["loss"]) <= 1e-5 * abs(want["loss"]), \
            (float(got["loss"]), want["loss"])
        for k, g in want["grads"].items():
            rel = np.linalg.norm(got[f"grad_{k}"] - g) / np.linalg.norm(g)
            assert rel < 1e-4, (k, rel)
            # SGD took the all-reduced gradient on every rank
            np.testing.assert_array_equal(got[f"param_{k}"],
                                          np.float32(-LR) * got[f"grad_{k}"])


def test_dryrun_multichip_on_four_ranks(runs):
    """(g): both programs pass on every rank and agree across ranks."""
    results, _, _ = runs
    rows = results["dryrun"]
    for k in ("loss", "mean_return", "reward", "grad"):
        assert np.isfinite(rows[0][k]), k
        assert all(r[k] == rows[0][k] for r in rows), k
    assert rows[0]["grad"] != 0.0
