"""Differentiable-physics policy training on LunarLander, on one GPU.

Analytic policy gradients through the contact dynamics: each step rolls
the policy out for ``--horizon`` env steps, differentiates the discounted
return through the physics (the contact solve's reverse pass runs as its
CUDA kernel) and takes one Adam step.  The port of
``examples/train_lander.py``: as there, the horizon runs in 4 checkpoint
segments (4 must divide ``--horizon``), the world batch is sharded over a
world mesh (``parallel/mesh.py``: one rank a device, the gradients
all-reduced once a step) and a rank's batch above ``--chunk`` runs as
waves.  The policy's initial weights come from numpy seed 0, not from
jax.random, so its numbers are not the JAX example's.

Run:  python -m parallax_tpu_torch.examples.train_lander [--steps 50]
      [--batch 256] [--horizon 100] [--chunk N] [--remat-steps] [--device cpu]
On N GPUs (``--batch`` is the fleet's, split over the ranks):
      torchrun --nproc_per_node=N -m parallax_tpu_torch.examples.train_lander
      --chunk 4096
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from parallax_tpu_torch.envs.lunar_lander import LunarLander
from parallax_tpu_torch.parallel.mesh import (
    distributed_init,
    make_world_mesh,
    replicated,
    shard_batch,
)
from parallax_tpu_torch.parallel.rollout import adam, make_train_step


def init_params(obs_size: int, act_size: int, device) -> dict:
    """The 9-32-2 tanh policy's weights, as ``examples/train_lander.py``
    scales them (w1 * 0.3, w2 * 0.1, zero biases)."""
    rng = np.random.default_rng(0)
    arrays = {
        "w1": rng.standard_normal((obs_size, 32)) * 0.3,
        "b1": np.zeros(32),
        "w2": rng.standard_normal((32, act_size)) * 0.1,
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
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--horizon", type=int, default=100)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--remat-steps", action="store_true",
                   help="also checkpoint every step inside a segment")
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
    env = LunarLander(device=args.device)
    params = replicated(init_params(env.observation_size, env.action_size, env.device), mesh)
    train_step = make_train_step(
        env, policy, adam(params, args.lr), args.horizon, checkpoint_segments=4,
        max_chunk=args.chunk, mesh=mesh, remat_steps=args.remat_steps,
    )
    keys = np.random.default_rng(1).integers(
        0, 2**32, (args.batch, 2), dtype=np.uint32
    )
    states = env.reset_fn_batch(shard_batch(torch.from_numpy(keys.astype(np.int64)), mesh))

    if lead:
        print(f"device={env.device} ranks={mesh.size(0)} batch={args.batch} "
              f"horizon={args.horizon}")
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
