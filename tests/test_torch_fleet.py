"""The port's fleet on 4 and 2 gloo ranks on the CPU, against itself.

One module fixture starts both fleets (``tests/torch_fleet_worker.py``:
spawned ranks, a file rendezvous, one torch thread each) and, while they
run, the one-process rollouts they are held against:

* (a) the relayout: ``_mesh_chunked_rollout`` with the shape-invariant
  ``rollout_fn`` of ``tests/test_parallel.py``, at 8 and 11 worlds a rank
  and chunk 4, read whole through ``gather_batch``, is bitwise the function
  on the whole batch;
* (b) the mesh-chunked lander rollout (11 worlds a rank, chunk 4, 12
  steps) against the one-process chunked and unchunked rollouts, at the
  bars ``tests/test_parallel.py:231`` sets between JAX's mesh and
  one-device runs: pos and vel 5e-7, reward and obs 1e-6 absolute, the
  flags equal;
* (c) the collectives: none in a rollout, exactly one all-reduce in a
  train step;
* (d) every rank's loss, return and updated parameters bitwise equal to
  the others', at 2 and at 4 ranks (the counterpart of
  ``tests/test_distributed.py``'s checksums).
"""

import numpy as np
import pytest

from parallax_tpu_torch.envs.lunar_lander import LunarLander
from torch_fleet_worker import (
    COLLECTIVES,
    FLEET_CHUNK,
    FLEET_PER_RANK,
    FLEET_STEPS,
    Fleet,
    const_policy,
    jax_keys,
    relayout_fn,
    relayout_states,
    rollout_arrays,
)

BARS = {"pos": 5e-7, "vel": 5e-7, "reward": 1e-6, "obs": 1e-6}


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    runs = {4: Fleet(tmp_path_factory.mktemp("fleet4"), 4, ("relayout", "lander", "train")),
            2: Fleet(tmp_path_factory.mktemp("fleet2"), 2, ("train",))}
    env = LunarLander(device="cpu")
    start = env.reset_fn_batch(jax_keys(1, 4 * FLEET_PER_RANK))
    one_process = {
        label: rollout_arrays(*env.rollout_batch(start, const_policy, FLEET_STEPS,
                                                  max_chunk=chunk))
        for label, chunk in (("chunked", FLEET_CHUNK), ("unchunked", 0))
    }
    return {n: fleet.results() for n, fleet in runs.items()}, one_process


def test_mesh_relayout_is_bitwise(fleets):
    """(a): a world in the wrong wave or put back out of order moves whole
    worlds, not ulps."""
    results, _ = fleets
    for per_rank in (8, 11):
        final, traj = relayout_fn(relayout_states(4 * per_rank))
        for rank in results[4]["relayout"]:
            np.testing.assert_array_equal(rank[f"final{per_rank}"], final["a"].numpy())
            np.testing.assert_array_equal(rank[f"traj{per_rank}"], traj.numpy())


def test_mesh_lander_rollout_matches_one_process(fleets):
    """(b): 44 worlds on 4 ranks at 11 a rank (2 waves and a remainder of 3)."""
    results, one_process = fleets
    got = results[4]["lander"][0]
    for label, want in one_process.items():
        for k, bar in BARS.items():
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=bar, err_msg=f"{label} {k}")
        for flag in ("terminated", "truncated"):
            np.testing.assert_array_equal(got[flag], want[flag], err_msg=f"{label} {flag}")


def test_collectives_rollout_none_train_step_one(fleets):
    """(c): the rollout runs each rank's worlds alone; the train step makes
    one all-reduce of its bucket."""
    results, _ = fleets
    none = np.zeros(len(COLLECTIVES), np.int64)
    one_all_reduce = np.eye(len(COLLECTIVES), dtype=np.int64)[COLLECTIVES.index("all_reduce")]
    for rank in results[4]["relayout"]:
        assert rank["collectives8"] == 0 and rank["collectives11"] == 0
    for rank in results[4]["lander"]:
        np.testing.assert_array_equal(rank["collectives"], none)
    for n in (2, 4):
        for rank in results[n]["train"]:
            for step in range(2):
                np.testing.assert_array_equal(rank[f"collectives{step}"], one_all_reduce)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_ranks_agree_bitwise(fleets, n_ranks):
    """(d): the ranks start from different weights, take rank 0's through
    ``replicated`` and step on the same all-reduced gradients."""
    results, _ = fleets
    ranks = results[n_ranks]["train"]
    first = ranks[0]
    assert np.isfinite(first["loss1"]) and first["loss0"] != first["loss1"]
    assert all(np.abs(first[f"grad_{k}"]).max() > 0 for k in ("w", "b"))
    for other in ranks[1:]:
        assert set(other) == set(first)
        for k, v in first.items():
            if not k.startswith("collectives"):
                np.testing.assert_array_equal(other[k], v, err_msg=k)
