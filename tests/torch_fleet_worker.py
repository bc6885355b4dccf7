"""One rank of the port's fleet tests: torch, numpy and the port, never jax.

``tests/test_torch_fleet.py`` and ``tests/test_torch_fleet_jax.py`` start
a :class:`Fleet`: N ranks of :func:`rank_main` with the
``spawn`` start method on gloo, rendezvous through a file (no TCP port, so
parallel test workers cannot race for one), and collects what each rank
wrote as ``{part}_rank{r}.npz`` into the run's directory.  Each rank uses
one torch thread.

Parts (each rank runs the listed ones, in order):

* ``relayout``: ``_mesh_chunked_rollout`` with ``tests/test_parallel.py``'s
  shape-invariant ``rollout_fn`` at 8 and 11 worlds a rank, chunk 4, read
  whole through ``gather_batch``;
* ``lander``: the mesh-chunked lander rollout (11 worlds a rank, chunk 4,
  12 steps) with its collectives counted, read whole;
* ``train``: two lander train steps on the mesh (11 worlds a rank, chunk
  4, 4 steps in 2 segments, Adam), the collectives of each counted, and
  this rank's loss, return and updated parameters;
* ``jax_rollout``: the lander rollout of ``JAX_FLEET_B`` worlds
  (``PRNGKey(1)``), 12 steps, chunk 5 on this rank's share, read whole,
  with the start states;
* ``jax_train``: one train step of ``test_parallel.py``'s mesh-chunked
  configuration (``JAX_FLEET_B`` worlds from ``PRNGKey(2)``, 4 steps, zero
  weights, SGD at 1e-2) at chunk 5, with the gradients and the start
  states;
* ``dryrun``: ``parallel/dryrun.py:dryrun_multichip`` on the mesh.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
               "reduce_scatter", "reduce_scatter_tensor", "all_to_all", "barrier")
CONST_ACTION = (0.4, 0.05)  # test_parallel.py's policy: one action for every world
FLEET_STEPS, FLEET_CHUNK, FLEET_PER_RANK = 12, 4, 11
RELAYOUT_STEPS = 3
# the worlds of the runs held against JAX's 8-device mesh: 8 a device at
# chunk 4 there (two whole waves), 16 a rank at chunk 5 on 4 ranks here
JAX_FLEET_B, JAX_FLEET_CHUNK = 64, 5


@contextlib.contextmanager
def counting_collectives():
    """Count the calls of every ``torch.distributed`` collective made
    inside the block (the port looks them up on the module at call time)."""
    counts = dict.fromkeys(COLLECTIVES, 0)
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def wrap(name):
        def counted(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return counted

    for name in COLLECTIVES:
        setattr(dist, name, wrap(name))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def jax_keys(seed: int, batch: int) -> torch.Tensor:
    """``jax.random.split(jax.random.PRNGKey(seed), batch)``."""
    from parallax_tpu_torch.utils import prng

    return prng.split(torch.tensor([0, seed], dtype=torch.int64), batch)


def const_policy(_, obs):
    return torch.tensor(CONST_ACTION).expand(obs.shape[0], 2)


def linear_policy(p, obs):
    return torch.tanh(obs @ p["w"] + p["b"])


def relayout_fn(states):
    """``tests/test_parallel.py``'s per-world function built only of exactly
    rounded ops (a power-of-two product, one multiply-add), so its result
    cannot depend on the batch it runs at."""
    final = {"a": states["a"] * 2.0 + 1.0}
    traj = torch.stack([states["a"] * float(2 ** t) for t in range(RELAYOUT_STEPS)])
    return final, traj


def relayout_states(batch: int) -> dict:
    a = torch.arange(batch * 2, dtype=torch.float32).reshape(batch, 2) * 0.3333333333 + 7.0
    return {"a": a}


def mlp_arrays() -> dict:
    rng = np.random.default_rng(5)
    return {"w": (rng.standard_normal((9, 2)) * 0.3).astype(np.float32),
            "b": np.zeros(2, np.float32)}


def rollout_arrays(final, traj) -> dict:
    return {
        "pos": final.bodies.pos.numpy(), "vel": final.bodies.vel.numpy(),
        "reward": traj.reward.numpy(), "obs": traj.obs.numpy(),
        "terminated": traj.terminated.numpy(), "truncated": traj.truncated.numpy(),
    }


def _part_relayout(mesh, rank):
    from parallax_tpu_torch.parallel.mesh import gather_batch, shard_batch
    from parallax_tpu_torch.parallel.rollout import _mesh_chunked_rollout

    out = {}
    n = mesh.size(0)
    for per_rank in (8, 11):  # 2 full waves; 2 full waves and a remainder of 3
        shard = shard_batch(relayout_states(n * per_rank), mesh)
        with counting_collectives() as counts:
            final, traj = _mesh_chunked_rollout(relayout_fn, shard, RELAYOUT_STEPS, per_rank,
                                                FLEET_CHUNK, mesh, "worlds")
        out[f"final{per_rank}"] = gather_batch(final, mesh)["a"].numpy()
        out[f"traj{per_rank}"] = gather_batch(traj, mesh, dim=1).numpy()
        out[f"collectives{per_rank}"] = np.array(sum(counts.values()))
    return out


def _part_lander(mesh, rank):
    from parallax_tpu_torch.envs.lunar_lander import LunarLander
    from parallax_tpu_torch.parallel.mesh import gather_batch, shard_batch

    env = LunarLander(device="cpu")
    states = shard_batch(env.reset_fn_batch(jax_keys(1, FLEET_PER_RANK * mesh.size(0))), mesh)
    with counting_collectives() as counts:
        final, traj = env.rollout_batch(states, const_policy, FLEET_STEPS, max_chunk=FLEET_CHUNK,
                                        mesh=mesh)
    out = rollout_arrays(gather_batch(final, mesh), gather_batch(traj, mesh, dim=1))
    out["collectives"] = np.array([counts[k] for k in COLLECTIVES])
    return out


def _part_train(mesh, rank):
    from parallax_tpu_torch.envs.lunar_lander import LunarLander
    from parallax_tpu_torch.parallel.mesh import replicated, shard_batch
    from parallax_tpu_torch.parallel.rollout import adam, make_train_step

    env = LunarLander(device="cpu")
    arrays = mlp_arrays()
    if rank:  # replicated() must make every rank hold rank 0's weights
        arrays = {k: v + 1.0 for k, v in arrays.items()}
    params = replicated({k: torch.from_numpy(v).requires_grad_(True) for k, v in arrays.items()},
                        mesh)
    step = make_train_step(env, linear_policy, adam(params, 1e-2), 4, checkpoint_segments=2,
                           max_chunk=FLEET_CHUNK, mesh=mesh)
    states = shard_batch(env.reset_fn_batch(jax_keys(3, FLEET_PER_RANK * mesh.size(0))), mesh)
    out = {}
    for i in range(2):
        with counting_collectives() as counts:
            params, states, metrics = step(params, states)
        out[f"collectives{i}"] = np.array([counts[k] for k in COLLECTIVES])
        out[f"loss{i}"] = metrics["loss"].numpy()
        out[f"mean_return{i}"] = metrics["mean_return"].numpy()
    out.update({f"param_{k}": v.detach().numpy() for k, v in params.items()})
    out.update({f"grad_{k}": v.grad.numpy() for k, v in params.items()})
    return out


def _part_jax_rollout(mesh, rank):
    from parallax_tpu_torch.envs.lunar_lander import LunarLander
    from parallax_tpu_torch.parallel.mesh import gather_batch, shard_batch
    from parallax_tpu_torch.utils import convert

    env = LunarLander(device="cpu")
    start = env.reset_fn_batch(jax_keys(1, JAX_FLEET_B))
    final, traj = env.rollout_batch(shard_batch(start, mesh), const_policy, FLEET_STEPS,
                                    max_chunk=JAX_FLEET_CHUNK, mesh=mesh)
    out = rollout_arrays(gather_batch(final, mesh), gather_batch(traj, mesh, dim=1))
    out.update({f"start.{k}": v for k, v in convert.lander_state_to_numpy(start).items()})
    return out


def _part_jax_train(mesh, rank):
    from parallax_tpu_torch.envs.lunar_lander import LunarLander
    from parallax_tpu_torch.parallel.mesh import shard_batch
    from parallax_tpu_torch.parallel.rollout import make_train_step
    from parallax_tpu_torch.utils import convert

    env = LunarLander(device="cpu")
    params = {"w": torch.zeros(9, 2, requires_grad=True), "b": torch.zeros(2, requires_grad=True)}
    step = make_train_step(env, linear_policy, torch.optim.SGD(params.values(), lr=1e-2), 4,
                           max_chunk=JAX_FLEET_CHUNK, mesh=mesh)
    start = env.reset_fn_batch(jax_keys(2, JAX_FLEET_B))
    params, _, metrics = step(params, shard_batch(start, mesh))
    out = {"loss": metrics["loss"].numpy(), "mean_return": metrics["mean_return"].numpy()}
    out.update({f"grad_{k}": v.grad.numpy() for k, v in params.items()})
    out.update({f"param_{k}": v.detach().numpy() for k, v in params.items()})
    out.update({f"start.{k}": v for k, v in convert.lander_state_to_numpy(start).items()})
    return out


def _part_dryrun(mesh, rank):
    from parallax_tpu_torch.parallel.dryrun import dryrun_multichip

    return {k: np.array(v) for k, v in dryrun_multichip(mesh).items()}


PARTS = {
    "relayout": _part_relayout, "lander": _part_lander, "train": _part_train,
    "jax_rollout": _part_jax_rollout, "jax_train": _part_jax_train, "dryrun": _part_dryrun,
}


def rank_main(rank: int, world_size: int, run_dir: str, parts: tuple) -> None:
    """One rank: join the gloo group, build the world mesh, run ``parts``
    and write each one's arrays as ``{part}_rank{rank}.npz``."""
    torch.set_num_threads(1)
    from parallax_tpu_torch.parallel.mesh import distributed_init, make_world_mesh

    distributed_init(f"file://{os.path.join(run_dir, 'rendezvous')}", world_size=world_size,
                     rank=rank, device="cpu")
    try:
        mesh = make_world_mesh("cpu")
        for part in parts:
            out = PARTS[part](mesh, rank)
            np.savez(os.path.join(run_dir, f"{part}_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


class Fleet:
    """A started run of ``world_size`` ranks; :meth:`results` waits for it."""

    def __init__(self, run_dir, world_size: int, parts: tuple):
        import torch.multiprocessing as mp

        self.run_dir, self.world_size, self.parts = str(run_dir), world_size, parts
        os.makedirs(self.run_dir, exist_ok=True)
        self.context = mp.start_processes(rank_main, args=(world_size, self.run_dir, parts),
                                          nprocs=world_size, join=False, start_method="spawn")

    def results(self, timeout: float = 300.0) -> dict:
        """``{part: [rank 0's arrays, rank 1's, ...]}``; a rank's exception
        is raised here, and a run past ``timeout`` seconds is killed."""
        deadline = time.monotonic() + timeout
        while not self.context.join(timeout=1.0):
            if time.monotonic() > deadline:
                for p in self.context.processes:
                    p.kill()
                raise TimeoutError(f"fleet of {self.world_size} ranks ran past {timeout} s")
        assert not any(p.is_alive() for p in self.context.processes)
        return {
            part: [dict(np.load(os.path.join(self.run_dir, f"{part}_rank{r}.npz")))
                   for r in range(self.world_size)]
            for part in self.parts
        }
