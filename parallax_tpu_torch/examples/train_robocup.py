"""Differentiable-physics multi-agent training on RoboCup SSL, on one GPU.

One shared policy drives every robot; gradients of the discounted
goal and progress reward flow through robot-ball-wall contact dynamics
over the whole rollout (the contact solve's reverse pass runs as its CUDA
kernel, or with ``--fused`` the fused step's).  The port of
``examples/train_robocup.py`` for one device: the same obs-64-action tanh
policy, Adam and ``make_train_step`` without checkpoint segments, on a
world mesh (``parallel/mesh.py``: one rank a device, the batch sharded,
the gradients all-reduced once a step), a rank's batch above ``--chunk``
in waves.  The policy's initial weights come from numpy seed 0, not from
jax.random, so its numbers are not the JAX example's.

Run:  python -m parallax_tpu_torch.examples.train_robocup [--steps 30]
      [--batch 128] [--horizon 60] [--robots 2] [--chunk N] [--fused]
      [--device cpu]
On N GPUs: torchrun --nproc_per_node=N -m parallax_tpu_torch.examples.train_robocup
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig
from parallax_tpu_torch.parallel.mesh import (
    distributed_init,
    make_world_mesh,
    replicated,
    shard_batch,
)
from parallax_tpu_torch.parallel.rollout import adam, make_train_step


def init_params(obs_size: int, act_size: int, device) -> dict:
    """The obs-64-action tanh policy's weights, scaled as
    ``examples/train_robocup.py`` scales them (w1 * 0.2, w2 * 0.1, zero
    biases)."""
    rng = np.random.default_rng(0)
    arrays = {
        "w1": rng.standard_normal((obs_size, 64)) * 0.2,
        "b1": np.zeros(64),
        "w2": rng.standard_normal((64, act_size)) * 0.1,
        "b2": np.zeros(act_size),
    }
    return {
        k: torch.tensor(v, dtype=torch.float32, device=device).requires_grad_(True)
        for k, v in arrays.items()
    }


def policy(p, obs):
    return torch.tanh(torch.tanh(obs @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--horizon", type=int, default=60)
    p.add_argument("--robots", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--fused", action="store_true",
                   help="run the whole physics step as the fused kernel")
    p.add_argument("--chunk", type=int, default=None,
                   help="per-device wave size for fleets above one chunk a device "
                        "(default: parallel.rollout.ROLLOUT_CHUNK)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if "WORLD_SIZE" in os.environ:  # launched by torchrun
        distributed_init(auto=True, device=args.device)
    # the mesh first: on CUDA it makes the rank's card the current device
    mesh = make_world_mesh(args.device)
    try:
        return _train(args, mesh)
    finally:
        torch.distributed.destroy_process_group()


def _train(args, mesh):
    lead = torch.distributed.get_rank() == 0  # prints for the fleet
    env = RoboCup(RoboCupConfig(n_robots_per_team=args.robots, use_cuda_fused=args.fused),
                  device=args.device)
    params = replicated(init_params(env.observation_size, env.action_size, env.device), mesh)
    train_step = make_train_step(env, policy, adam(params, args.lr), args.horizon,
                                 max_chunk=args.chunk, mesh=mesh)
    keys = np.random.default_rng(1).integers(0, 2**32, (args.batch, 2), dtype=np.uint32)
    states = env.reset_fn_batch(shard_batch(torch.from_numpy(keys.astype(np.int64)), mesh))

    if lead:
        print(f"device={env.device} ranks={mesh.size(0)} batch={args.batch} "
              f"horizon={args.horizon} robots={args.robots}v{args.robots} fused={args.fused}")
    for i in range(args.steps):
        t0 = time.perf_counter()
        params, states, metrics = train_step(params, states)
        ret = metrics["mean_return"].item()  # waits for the step
        dt = time.perf_counter() - t0
        if lead:
            print(
                f"step {i:3d}  return={ret:8.3f}  "
                f"loss={metrics['loss'].item():8.3f}  {dt * 1000:6.1f} ms"
            )
    return params, metrics


if __name__ == "__main__":
    main()
