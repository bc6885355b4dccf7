"""Render a rollout of any bundled env to frames (a GIF when pillow is
installed, else ``.npy`` frames).

The port of ``examples/render_rollout.py``: one world stepped through the
per-world ``env.step`` under a scripted action, every ``--every``-th state
rendered by ``viz.Renderer`` from a host copy.

Run:  python -m parallax_tpu_torch.examples.render_rollout [--device cpu]
      [--env lander|robocup|billiards|bouncer] [--steps 300] [--out DIR]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from parallax_tpu_torch.envs.billiards import Billiards
from parallax_tpu_torch.envs.bouncer import Bouncer
from parallax_tpu_torch.envs.lunar_lander import LunarLander
from parallax_tpu_torch.envs.robocup import RoboCup
from parallax_tpu_torch.viz import Renderer, save_gif

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ENVS = {
    "lander": (LunarLander, (-8.0, 8.0, -6.0, 6.0)),
    "robocup": (RoboCup, (-5.5, 5.5, -4.0, 4.0)),
    "billiards": (Billiards, (-1.3, 1.3, -0.8, 0.8)),
    "bouncer": (Bouncer, (-2.5, 2.5, -2.5, 2.5)),
}


def scripted_action(name, env, state, i):
    dev = env.device
    if name == "lander":
        throttle = 0.45 if state.bodies.vel[0, 1].item() < -0.3 else 0.1
        return torch.tensor([throttle, 0.0], device=dev)
    if name in ("billiards", "bouncer"):
        return torch.tensor([1.0, 0.1] if i < 60 else [0.0, 0.0], device=dev)
    # robocup: every robot drives forward
    a = torch.zeros(env.action_size, device=dev)
    a[0::2] = 0.6
    return a


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--env", choices=sorted(ENVS), default="lander")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--every", type=int, default=5)
    p.add_argument("--out", default=None, help="default: build/<env>_frames")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cls, extent = ENVS[args.env]
    env = cls(device=args.device)
    out_dir = args.out or os.path.join(REPO, "build", f"{args.env}_frames")
    state = env.reset(torch.tensor([0, 0], device=env.device))  # PRNGKey(0)
    r = Renderer(width=400, height=300, extent=extent)

    os.makedirs(out_dir, exist_ok=True)
    frames = []
    with torch.no_grad():
        for i in range(args.steps):
            state, _ = env.step(state, scripted_action(args.env, env, state, i))
            if i % args.every == 0:
                frames.append(r.render_env(env, state))
    print(f"rendered {len(frames)} frames")

    try:
        save_gif(frames, os.path.join(out_dir, "rollout.gif"), fps=20)
        print("wrote", os.path.join(out_dir, "rollout.gif"))
    except ImportError:
        for i, f in enumerate(frames):
            np.save(os.path.join(out_dir, f"frame_{i:04d}.npy"), f)
        print("pillow unavailable; wrote .npy frames to", out_dir)
    return frames


if __name__ == "__main__":
    main()
