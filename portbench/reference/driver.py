"""The step every parallax env shares (the JAX package's
``envs/plane_env.py``), over a reference env of this folder:

* ``step``: the env's step (its action kick, physics, reward and
  termination), ``t + 1``, the observation; a watchdog that truncates a
  world where any body plane, any floating part of the env's state, the
  reward or the observation is not finite (and zeroes its reward and
  observation); truncation at the step limit; then the auto-reset: the
  key splits in two, the first drawing the finished worlds' fresh state,
  the second carried on; a finished world takes the fresh state and
  ``t = 0``;
* ``raw_step``: the env's step and observation alone (no watchdog, no
  auto-reset, the key kept), truncated at the step limit only;
* ``rollout``: the policy acts on each step's observation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference import threefry


class TimeStep(NamedTuple):
    obs: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor


def _finite_rows(x):
    return torch.isfinite(x).reshape(x.shape[0], -1).all(-1)


def _where_done(done, fresh, cur):
    def pick(f, c):
        d = done.reshape((-1,) + (1,) * (c.dim() - 1))
        return torch.where(d, f, c)

    if isinstance(cur, tuple):
        return type(cur)(*(_where_done(done, f, c) for f, c in zip(fresh, cur)))
    return pick(fresh, cur) if torch.is_tensor(cur) else cur


def step(env, st, actions):
    new, reward, terminated = env.step(st, actions)
    t = st.t + 1
    obs = env.obs(new)
    finite = _finite_rows(reward[:, None]) & _finite_rows(obs)
    for leaf in env.float_leaves(new):
        finite = finite & _finite_rows(leaf)
    truncated = ((t >= env.max_steps) & ~terminated) | ~finite
    done = terminated | truncated
    ts = TimeStep(torch.where(finite[:, None], obs, torch.zeros_like(obs)),
                  torch.where(finite, reward, torch.zeros_like(reward)), terminated, truncated)
    keys = threefry.split(st.key, 2)
    fresh = env.fresh(keys[:, 0], new)
    out = _where_done(done, fresh, new)
    out = out._replace(t=torch.where(done, torch.zeros_like(t), t), key=keys[:, 1])
    return out, ts


def raw_step(env, st, actions):
    new, reward, terminated = env.step(st, actions)
    t = st.t + 1
    ts = TimeStep(env.obs(new), reward, terminated, (t >= env.max_steps) & ~terminated)
    return new._replace(t=t), ts


def rollout(env, st, policy, params, n_steps, hook=None):
    """``n_steps`` of ``policy(params, obs)``: ``(final state, TimeStep
    stacked [T, B, ...])``; ``hook`` maps each step's new state (the
    control's rounding)."""
    out = []
    for _ in range(n_steps):
        st, ts = step(env, st, policy(params, env.obs(st)))
        if hook is not None:
            st = hook(st)
        out.append(ts)
    return st, TimeStep(*(torch.stack(x) for x in zip(*out)))
