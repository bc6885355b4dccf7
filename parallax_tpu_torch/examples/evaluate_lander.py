"""Continuous-time evaluation of LunarLander: the reference's NFE/WFE API.

A Judge with integral reward R = ∫ r(s, u) dt + terminal bonus, a Control
queried once per NFE that returns a dense-in-time signal, premature out
on landing or crash (``envs/base.evaluate``), and, since the whole loop is
differentiable under autograd, the gradient of the continuous-time return
with respect to the control.  The port of ``examples/evaluate_lander.py``;
the world runs ``World.step`` per world.

Run:  python -m parallax_tpu_torch.examples.evaluate_lander [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from parallax_tpu_torch.envs.base import ConstantControl, evaluate
from parallax_tpu_torch.envs.lunar_lander import LanderJudge, LunarLander, make_world_forward


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    env = LunarLander(device=args.device)
    state = env.reset(torch.tensor([0, 1], device=env.device))  # PRNGKey(1)
    bodies, terrain = state.bodies, state.terrain
    judge = LanderJudge(env, terrain)
    forward = make_world_forward(env, terrain)

    def run(throttle, num_nfes=30, wfe_scale=10):
        control = ConstantControl(torch.stack([throttle, torch.zeros_like(throttle)]))
        _, reward = evaluate(forward, bodies, control, judge, eval_period=3.0,
                             num_nfes=num_nfes, wfe_scale=wfe_scale)
        return reward

    out = {}
    with torch.no_grad():
        for throttle in (0.0, 0.25, 0.5):
            r = run(torch.tensor(throttle, device=env.device)).item()
            out[throttle] = r
            print(f"throttle={throttle:4.2f}  continuous-time return = {r:8.3f}")

    throttle = torch.tensor(0.25, device=env.device, requires_grad=True)
    run(throttle).backward()
    g = throttle.grad.item()
    print(f"d(return)/d(throttle) at 0.25 = {g:.4f}  (finite: {bool(torch.isfinite(throttle.grad))})")

    # resolution refinement: more NFEs, finer control sampling, the same period
    with torch.no_grad():
        r60 = run(torch.tensor(0.25, device=env.device), 60, 5).item()
    print(f"same period at 60 NFE x 5 WFE: return = {r60:8.3f} (should be close)")
    return out, g, r60


if __name__ == "__main__":
    main()
