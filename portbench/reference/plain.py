"""The plain reference's loops over the envs of this folder: the rollout,
the train step's loss and Adam, and the shooting loss.  Nothing here
imports the program.

``round_bf16`` is the control's lower precision: the reference with every
floating plane of the carried state, and the policy's weights or the plan,
rounded to bfloat16 after each step.

Under a gradient every env step is checkpointed (only its input state is
kept for the backward): the memory of a step's internals at the fleet's
size times the horizon would not fit the card.
"""

from __future__ import annotations

import importlib

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import driver


def mlp(p, obs):
    """obs -> tanh hidden -> tanh actions."""
    return torch.tanh(torch.tanh(obs @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])


def reference_env(config: dict, device):
    """The reference's env for a configuration file: its ``reference`` names
    the module of this folder and the class (``"lander:LunarLander"``),
    built from the configuration's flags."""
    module, name = config["reference"].split(":")
    env = getattr(importlib.import_module(f"portbench.reference.{module}"), name)
    return env(device, **config["config"])


def round_bf16(tree):
    """Every floating tensor of a tree rounded to bfloat16 and back."""
    if isinstance(tree, tuple):
        return type(tree)(*(round_bf16(x) for x in tree))
    if isinstance(tree, dict):
        return {k: round_bf16(v) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(torch.bfloat16).to(tree.dtype)
    return tree


def _detach(tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_detach(x) for x in tree))
    return tree.detach() if torch.is_tensor(tree) else tree


def rollout(env, state, params, n_steps, control=False):
    """``n_steps`` of the policy with auto-reset: ``(final, TimeStep [T, B])``."""
    with torch.no_grad():
        if control:
            return driver.rollout(env, state, mlp, round_bf16(params), n_steps, hook=round_bf16)
        return driver.rollout(env, state, mlp, params, n_steps)


def _flat(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _flat(t)]
    return [tree]


def _unflat(like, flat):
    it = iter(flat)

    def build(t):
        if isinstance(t, tuple):
            return type(t)(*(build(x) for x in t))
        return next(it)

    return build(like)


def _checkpointed(fn, state, *args):
    """``fn(state, *args) -> (state, reward)`` with only its inputs kept."""
    flat = _flat(state)

    def run(*xs):
        new, reward = fn(_unflat(state, xs[: len(flat)]), *xs[len(flat):])
        return (*_flat(new), reward)

    out = checkpoint(run, *flat, *args, use_reentrant=False)
    return _unflat(state, out[:-1]), out[-1]


def train_loss(env, params, state, horizon, discount, control=False):
    """The train step's loss: minus the mean discounted return of a
    ``horizon``-step rollout of the policy, auto-reset on; ``(loss, final)``."""
    p = round_bf16(params) if control else params

    def one(st, *leaves):
        q = dict(zip(p, leaves))
        st, ts = driver.step(env, st, mlp(q, env.obs(st)))
        return (round_bf16(st) if control else st), ts.reward

    rewards = []
    for _ in range(horizon):
        state, r = _checkpointed(one, state, *p.values())
        rewards.append(r)
    disc = discount ** torch.arange(horizon, dtype=torch.float32, device=rewards[0].device)
    ret = torch.sum(torch.stack(rewards) * disc[:, None], dim=0)
    return -torch.mean(ret), state


def train_steps(env, params0, state, n, horizon, discount, lr, control=False):
    """``n`` train steps with Adam (b1 0.9, b2 0.999, eps 1e-8), each from
    the states the last reached: the losses, the first step's gradient and
    the parameters after ``n``."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses, grad1 = [], None
    for _ in range(n):
        opt.zero_grad(set_to_none=True)
        loss, state = train_loss(env, params, state, horizon, discount, control)
        loss.backward()
        if grad1 is None:
            grad1 = {k: v.grad.detach().clone() for k, v in params.items()}
        opt.step()
        state = _detach(state)
        losses.append(float(loss.detach()))
    return losses, grad1, {k: v.detach() for k, v in params.items()}


def shoot_loss(env, state, plan, control=False):
    """Minus the mean over worlds of the reward summed over the plan's
    actions (``[T, B, act]``), through the raw step."""
    def one(st, a):
        st, ts = driver.raw_step(env, st, round_bf16(a) if control else a)
        return (round_bf16(st) if control else st), ts.reward

    total = 0.0
    for t in range(plan.shape[0]):
        state, r = _checkpointed(one, state, plan[t])
        total = total + r
    return -torch.mean(total)


def shoot_steps(env, state, plan0, n, lr, control=False):
    """``n`` shooting iterations with Adam on the plan: the losses, the first
    gradient and the plan after ``n``."""
    plan = plan0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([plan], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses, grad1 = [], None
    for _ in range(n):
        opt.zero_grad(set_to_none=True)
        loss = shoot_loss(env, state, plan, control)
        loss.backward()
        if grad1 is None:
            grad1 = plan.grad.detach().clone()
        opt.step()
        losses.append(float(loss.detach()))
    return losses, grad1, plan.detach()
