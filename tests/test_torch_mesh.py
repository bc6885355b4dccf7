"""The port's ``parallel/mesh.py`` in one process, and the last helpers.

A one-rank gloo group is opened here (``make_world_mesh("cpu")``) and
destroyed when the module ends, so later files on the same worker start
clean.  Checked:

* the one-rank world mesh, its axis names, ``distributed_init``'s bare
  no-op and ``host_local_batch``;
* the axis resolution of ``chunked_rollout``: a 1-D mesh under another dim
  name resolves, a 2-D mesh without ``axis`` raises ``ValueError``, an
  object that is not a mesh ``TypeError``;
* ``shard_batch``'s block layout and its warning, on a stand-in mesh of 4
  ranks (the spawned ranks of ``tests/test_torch_fleet.py`` hold the real
  layout to the bit);
* the one-rank mesh is bitwise the plain path: a chunked lander rollout
  (no collective) and a train step (one all-reduce);
* ``envs/lunar_lander.py:terrain_vertices`` and ``utils/pytree.py``'s
  helpers against the JAX package's, to the bit.
"""

import warnings
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from parallax_tpu.envs import lunar_lander as jll
from parallax_tpu.utils import pytree as jpt
from parallax_tpu_torch.envs.lunar_lander import (
    LunarLander,
    terrain_vertices,
    terrain_vertices_batch,
)
from parallax_tpu_torch.parallel import mesh as tmesh
from parallax_tpu_torch.parallel.rollout import adam, chunked_rollout, make_train_step
from parallax_tpu_torch.utils import pytree as tpt
from torch_fleet_worker import counting_collectives, jax_keys, mlp_arrays, relayout_fn

B, CHUNK, STEPS = 10, 4, 6  # 2 waves and a remainder of 2


@pytest.fixture(scope="module")
def mesh():
    m = tmesh.make_world_mesh("cpu")
    yield m
    dist.destroy_process_group()


def test_one_rank_world_mesh(mesh):
    assert mesh.mesh_dim_names == (tmesh.WORLD_AXIS,) == ("worlds",)
    assert tmesh.axis_group(mesh) == (1, 0, mesh.get_group(0))
    assert mesh.device_type == "cpu" and dist.get_backend() == "gloo"
    assert tmesh.distributed_init() is None and dist.get_world_size() == 1
    assert tmesh.host_local_batch(12) == 12
    with mock.patch.object(dist, "get_world_size", return_value=4):
        assert tmesh.host_local_batch(12) == 3
        with pytest.raises(ValueError, match="not divisible"):
            tmesh.host_local_batch(10)
    # replicated and gather_batch at one rank: the tree as it was
    tree = {"a": torch.arange(6.0).reshape(3, 2).requires_grad_(True), "n": 3}
    rep = tmesh.replicated(tree, mesh)
    assert rep["n"] == 3 and rep["a"].requires_grad and rep["a"].is_leaf
    assert torch.equal(rep["a"], tree["a"])
    assert torch.equal(tmesh.gather_batch(torch.tensor([True, False]), mesh),
                       torch.tensor([True, False]))


def test_chunked_rollout_axis_resolution(mesh):
    states = {"a": torch.arange(16.0).reshape(8, 2)}
    want = relayout_fn(states)
    custom = tmesh.make_world_mesh("cpu", axis="fleet")
    assert tmesh.mesh_axis(custom) == "fleet"
    two_d = init_device_mesh("cpu", (1, 1), mesh_dim_names=("a", "b"))
    for m, axis in ((mesh, "worlds"), (custom, "worlds"), (two_d, "b")):
        final, traj = chunked_rollout(relayout_fn, states, 3, 8, max_chunk=3, mesh=m, axis=axis)
        assert torch.equal(final["a"], want[0]["a"]) and torch.equal(traj, want[1])
    with pytest.raises(ValueError, match="pass axis= explicitly"):
        chunked_rollout(relayout_fn, states, 3, 8, max_chunk=3, mesh=two_d)
    with pytest.raises(TypeError, match="DeviceMesh"):
        chunked_rollout(relayout_fn, states, 3, 8, max_chunk=3, mesh=object())


def test_shard_batch_blocks_and_warning():
    tree = {"x": torch.arange(24.0).reshape(8, 3), "k": torch.arange(8), "s": torch.tensor(2.0)}
    for rank in range(4):
        fake = mock.create_autospec(DeviceMesh, instance=True)
        fake.mesh_dim_names, fake.ndim, fake.device_type = ("worlds",), 1, "cpu"
        fake.size.return_value, fake.get_local_rank.return_value = 4, rank
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = tmesh.shard_batch(tree, fake)
        assert torch.equal(got["x"], tree["x"][2 * rank:2 * rank + 2])
        assert torch.equal(got["k"], tree["k"][2 * rank:2 * rank + 2])
        assert torch.equal(got["s"], tree["s"])
        with pytest.warns(UserWarning, match=r"1 leaves .* \(e\.g\. \(6,\)\) were REPLICATED"):
            odd = tmesh.shard_batch({"x": tree["x"], "odd": torch.arange(6)}, fake)
        assert torch.equal(odd["odd"], torch.arange(6))


def test_one_rank_mesh_is_the_plain_path(mesh):
    env = LunarLander(device="cpu")
    start = env.reset_fn_batch(jax_keys(4, B))

    def policy(p, obs):
        return torch.tanh(obs @ p["w"] + p["b"])

    p = {k: torch.from_numpy(v) for k, v in mlp_arrays().items()}
    with counting_collectives() as counts:
        got = env.rollout_batch(start, policy, STEPS, p, max_chunk=CHUNK, mesh=mesh)
    assert sum(counts.values()) == 0
    want = env.rollout_batch(start, policy, STEPS, p, max_chunk=CHUNK)
    for a, b in zip(tpt.tree_leaves(got), tpt.tree_leaves(want)):
        assert torch.equal(a, b)

    runs = []
    for m in (mesh, None):
        params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in mlp_arrays().items()}
        step = make_train_step(env, policy, adam(params), STEPS, checkpoint_segments=2,
                               max_chunk=CHUNK, mesh=m)
        with counting_collectives() as counts:
            params, _, metrics = step(params, start)
        runs.append((dict(counts), metrics, params))
    (c_mesh, m_mesh, p_mesh), (c_plain, m_plain, p_plain) = runs
    assert c_mesh["all_reduce"] == 1 and sum(c_mesh.values()) == 1 and sum(c_plain.values()) == 0
    for k in ("loss", "mean_return"):
        assert torch.equal(m_mesh[k], m_plain[k]), k
    for k in p_plain:
        assert torch.equal(p_mesh[k].grad, p_plain[k].grad) and torch.equal(p_mesh[k], p_plain[k])


def test_terrain_vertices_matches_jax():
    keys = np.random.default_rng(3).integers(0, 2**32, (6, 2), dtype=np.uint32)
    want = np.asarray(jax.jit(jax.vmap(jll.terrain_vertices))(jnp.asarray(keys)))
    tkeys = torch.from_numpy(keys.astype(np.int64))
    rows = terrain_vertices_batch(tkeys)
    for i in range(len(keys)):
        got = terrain_vertices(tkeys[i])
        assert got.shape == (7, want.shape[2], 2)
        np.testing.assert_array_equal(got.numpy(), want[i])
        assert torch.equal(got.reshape(-1), rows[i])


def test_pytree_helpers_match_jax():
    rng = np.random.default_rng(7)
    trees = [{"a": rng.standard_normal((3, 2)).astype(np.float32),
              "b": (rng.standard_normal(4).astype(np.float32),)} for _ in range(5)]
    tt = [tpt.tree_map(torch.from_numpy, t) for t in trees]
    jt = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]

    def same(t, j):
        for a, b in zip(tpt.tree_leaves(t), jax.tree_util.tree_leaves(j)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    for axis in (0, 1):
        stacked, jstacked = tpt.tree_stack(tt, axis=axis), jpt.tree_stack(jt, axis=axis)
        same(stacked, jstacked)
        for t, j in zip(tpt.tree_unstack(stacked, axis=axis), jpt.tree_unstack(jstacked, axis=axis)):
            same(t, j)
    stacked, jstacked = tpt.tree_stack(tt), jpt.tree_stack(jt)
    idx = torch.tensor([4, 0, 2])
    same(tpt.tree_get(stacked, idx), jpt.tree_get(jstacked, jnp.asarray(idx.numpy())))
    value = tpt.tree_map(lambda x: torch.full_like(x[0], 9.0), stacked)
    jvalue = jax.tree_util.tree_map(lambda x: jnp.full_like(x[0], 9.0), jstacked)
    set_t = tpt.tree_set(stacked, 1, value)
    same(set_t, jpt.tree_set(jstacked, 1, jvalue))
    same(stacked, jstacked)  # tree_set leaves its input as it was
    same(tpt.tree_zeros_like(stacked), jpt.tree_zeros_like(jstacked))
