"""Checkpoint / resume a training run mid-flight.

Trains the LunarLander differentiable-physics policy for a few steps,
checkpoints the policy parameters, the Adam state, the env-state fleet and
the step counter (``utils/checkpoint.py``: ``torch.save``), then takes the
next step twice: once in memory, once from the restored checkpoint with a
fresh optimizer.  The resumed run picks up exactly where the saved one
left off (the next returns are printed and compared bit for bit).  The
port of ``examples/checkpoint_resume.py``.

Run:  python -m parallax_tpu_torch.examples.checkpoint_resume [--device cpu]
      [--batch 32] [--horizon 40] [--path build/parallax_ckpt/ckpt.pt]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from parallax_tpu_torch.envs.lunar_lander import LunarLander
from parallax_tpu_torch.parallel.rollout import adam, make_train_step
from parallax_tpu_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def policy(p, obs):
    return torch.tanh(obs @ p["w"] + p["b"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--path", default=os.path.join(REPO, "build", "parallax_ckpt", "ckpt.pt"))
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--horizon", type=int, default=40)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    env = LunarLander(device=args.device)
    rng = np.random.default_rng(0)
    w = rng.standard_normal((env.observation_size, env.action_size)) * 0.1
    params = {
        "w": torch.tensor(w, dtype=torch.float32, device=env.device).requires_grad_(True),
        "b": torch.zeros(env.action_size, device=env.device, requires_grad=True),
    }
    optimizer = adam(params)
    train_step = make_train_step(env, policy, optimizer, args.horizon)
    keys = rng.integers(0, 2**32, (args.batch, 2), dtype=np.uint32).astype(np.int64)
    states = env.reset_fn_batch(torch.from_numpy(keys).to(env.device))

    for i in range(3):
        params, states, m = train_step(params, states)
        print(f"step {i}  return={m['mean_return'].item():.6f}")

    checkpoint.save(args.path, {"params": params, "opt_state": optimizer.state_dict(),
                                "states": states, "step": torch.tensor(3)})
    print("saved checkpoint to", args.path)

    # branch B's target: the structure, dtypes and devices to restore into
    target = {"params": {k: v.detach().clone() for k, v in params.items()},
              "opt_state": optimizer.state_dict(), "states": states, "step": torch.tensor(0)}
    # branch A: keep training in memory
    _, _, ma = train_step(params, states)

    # branch B: restore from disk, a fresh optimizer, the same step
    restored = checkpoint.restore(args.path, target)
    pb = {k: v.requires_grad_(True) for k, v in restored["params"].items()}
    opt_b = adam(pb)
    opt_b.load_state_dict(restored["opt_state"])
    _, _, mb = make_train_step(env, policy, opt_b, args.horizon)(pb, restored["states"])
    ra, rb = ma["mean_return"].item(), mb["mean_return"].item()
    print(f"resumed at step {int(restored['step'])}")
    print(f"in-memory  next return: {ra:.9f}")
    print(f"restored   next return: {rb:.9f}")
    print("bitwise-identical resume:", ra == rb)
    return ra, rb


if __name__ == "__main__":
    main()
