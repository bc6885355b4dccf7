"""Differentiable-physics policy training on LunarLander, on one GPU.

Analytic policy gradients through the contact dynamics: each step rolls
the policy out for ``--horizon`` env steps, differentiates the discounted
return through the physics (the contact solve's reverse pass runs as its
CUDA kernel) and takes one Adam step.  The port of
``examples/train_lander.py`` for one device; its mesh and wave options
are not ported (ROADMAP Queue 1 item 9).  As there, the horizon runs in 4
checkpoint segments (4 must divide ``--horizon``).  The policy's initial
weights come from numpy seed 0, not from jax.random, so its numbers are
not the JAX example's.

Run:  python -m parallax_tpu_torch.examples.train_lander [--steps 50]
      [--batch 256] [--horizon 100] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from parallax_tpu_torch.envs.lunar_lander import LunarLander
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
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    env = LunarLander(device=args.device)
    params = init_params(env.observation_size, env.action_size, env.device)
    train_step = make_train_step(
        env, policy, adam(params, args.lr), args.horizon,
        checkpoint_segments=4, remat_steps=args.remat_steps,
    )
    keys = np.random.default_rng(1).integers(
        0, 2**32, (args.batch, 2), dtype=np.uint32
    )
    states = env.reset_fn_batch(torch.from_numpy(keys.astype(np.int64)).to(env.device))

    print(f"device={env.device} batch={args.batch} horizon={args.horizon}")
    for i in range(args.steps):
        t0 = time.perf_counter()
        params, states, metrics = train_step(params, states)
        ret = metrics["mean_return"].item()  # waits for the step
        dt = time.perf_counter() - t0
        print(
            f"step {i:3d}  return={ret:8.3f}  "
            f"loss={metrics['loss'].item():8.3f}  {dt * 1000:6.1f} ms"
        )
    return params, metrics


if __name__ == "__main__":
    main()
