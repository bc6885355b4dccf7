"""Environment API: per-world reset/step with in-graph auto-reset, the
continuous-time Control/Judge evaluation, and the batched step.

The port of ``envs/base.py``.  A per-world function of the port takes
tensors with any leading batch axes: on one world (no leading axis) it is
the JAX package's function, on ``[B, ...]`` it is ``jax.vmap`` of it.  The
batch rank of a state is ``state.t.ndim``; every check JAX makes over a
whole world's tree runs here over each leaf's non-batch dims, per world.

1. **Discrete-step RL API.**  ``reset(key)`` and ``step(state, action)``;
   ``done`` worlds are re-initialized in place by masked selects (no host
   round trip).  ``BatchedEnvironmentMixin`` adds ``reset_batch`` and
   ``step_batch`` over batch-major states; the four envs take their
   ``step_batch`` from ``envs/plane_env.PlaneEnvMixin`` instead, the
   plane-space rollout's own step.
2. **Continuous-time evaluation** (reference parity): World dynamics, a
   dense-in-time Control and an integral-reward Judge, evaluated by the
   NFE/WFE loop (``evaluate``), with the premature-out state freeze and
   the dense control re-sampled after every sub-step; a Python loop, and
   differentiable in the control under autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from parallax_tpu_torch.utils import prng
from parallax_tpu_torch.utils.pytree import tree_leaves, tree_map, tree_select


class TimeStep(NamedTuple):
    """Per-step output bundle (brax/gymnax-style)."""

    obs: Any
    reward: torch.Tensor
    terminated: torch.Tensor  # episode ended by the MDP
    truncated: torch.Tensor  # episode ended by the time limit / watchdog
    info: Any = None

    @property
    def done(self):
        return self.terminated | self.truncated


def _all_finite(tree, batch_rank: int) -> torch.Tensor:
    """The batch-shaped bool: every float leaf of ``tree`` finite over its
    non-batch dims (vacuously True for a tree with no float leaf)."""
    ok = None
    for leaf in tree_leaves(tree):
        if torch.is_tensor(leaf) and leaf.is_floating_point():
            fin = torch.isfinite(leaf).reshape(leaf.shape[:batch_rank] + (-1,)).all(-1)
            ok = fin if ok is None else ok & fin
    return torch.tensor(True) if ok is None else ok


def _zero_where(bad, tree):
    """Zero the float leaves of ``tree`` in the worlds where ``bad``."""

    def f(x):
        if not (torch.is_tensor(x) and x.is_floating_point()):
            return x
        return torch.where(bad.reshape(bad.shape + (1,) * (x.ndim - bad.ndim)), 0.0, x)

    return tree_map(f, tree)


def _get_key(state):
    key = getattr(state, "key", None)
    if key is None:
        raise ValueError("env state must carry a `key` field for auto-reset")
    return key


class Environment:
    """Base class for parallax environments.

    Subclasses implement ``reset_fn(key) -> state`` and ``step_fn(state,
    action) -> (state, TimeStep)`` per world (with any leading batch axes);
    this base adds the auto-reset composition and rollouts.  States are
    NamedTuples that carry ``t`` (the step counter, batch-shaped) and
    ``key`` (``[..., 2]``, for in-graph re-randomization).
    """

    # -- to be provided by subclasses ---------------------------------------

    def reset_fn(self, key):
        raise NotImplementedError

    def step_fn(self, state, action):
        raise NotImplementedError

    @property
    def action_size(self) -> int:
        raise NotImplementedError

    @property
    def observation_size(self) -> int:
        raise NotImplementedError

    # -- public API ---------------------------------------------------------

    def reset(self, key):
        return self.reset_fn(key)

    def step(self, state, action):
        """Step + in-graph auto-reset.

        On ``done`` the returned state is a fresh reset drawn from the
        state's PRNG stream (``split(key) -> (reset, carry)``); the
        TimeStep still reports the terminal transition.  NaN watchdog: a
        world whose state, reward or obs goes non-finite is truncated and
        reset, and its emissions' float leaves (info included) are zeroed
        (a bitwise no-op for finite worlds).
        """
        new_state, ts = self.step_fn(state, action)
        nb = state.t.ndim
        bad = ~(_all_finite(new_state, nb) & _all_finite((ts.reward, ts.obs), nb))
        ts = ts._replace(
            truncated=ts.truncated | bad,
            reward=torch.where(bad, 0.0, ts.reward),
            obs=_zero_where(bad, ts.obs),
            info=_zero_where(bad, ts.info),
        )
        keys = prng.split(_get_key(new_state))  # [..., 2, 2]
        reset_key, carry_key = keys[..., 0, :], keys[..., 1, :]
        fresh = self.reset_fn(reset_key)._replace(key=carry_key)
        out = tree_select(ts.done, fresh, new_state._replace(key=carry_key))
        return out, ts

    # -- convenience --------------------------------------------------------

    def rollout(self, state, policy_fn, n_steps: int, policy_params=None):
        """A policy over ``n_steps`` steps: ``(final_state, TimeStep
        trajectory)``, the trajectory time-major ``[n_steps, ...]``."""
        tss = []
        for _ in range(n_steps):
            action = policy_fn(policy_params, _get_obs_for_policy(self, state))
            state, ts = self.step(state, action)
            tss.append(ts)
        return state, tree_map(lambda *xs: torch.stack(xs), *tss)


def _get_obs_for_policy(env, state):
    obs_fn = getattr(env, "observe", None)
    return obs_fn(state) if obs_fn else state


# ---------------------------------------------------------------------------
# Continuous-time semantics (reference parity layer)
# ---------------------------------------------------------------------------


class Judge:
    """Integral-reward judge: R = ∫ r(s, u) dt + r_final."""

    def reward(self, state, control_signal):
        raise NotImplementedError

    def is_done(self, state, control_signal):
        raise NotImplementedError

    def end_reward(self, state, control_signal):
        raise NotImplementedError


class Control:
    """Queried once per NFE; returns a dense-in-time control function and
    the updated control."""

    def __call__(self, state):
        raise NotImplementedError


@dataclasses.dataclass
class ConstantControl(Control):
    """Simplest dense control: a state-independent constant signal."""

    signal: Any

    def __call__(self, state):
        return (lambda s: self.signal), self


@dataclasses.dataclass
class PolicyControl(Control):
    """Zero-order hold of a policy network: the dense control function
    samples the policy once per NFE and holds it constant in between."""

    policy_fn: Callable
    params: Any
    observe: Callable

    def __call__(self, state):
        u = self.policy_fn(self.params, self.observe(state))
        return (lambda s: u), self


def evaluate(
    world_forward: Callable,
    state,
    control: Control,
    judge: Judge,
    eval_period: float,
    num_nfes: int,
    wfe_scale: int = 10,
):
    """The reference's NFE/WFE evaluation loop.

    ``world_forward(state, control_signal, dt) -> state``.  Per NFE: query
    the control once for a dense approximation, then run ``wfe_scale``
    world evaluations at ``dt = eval_period / num_nfes / wfe_scale``,
    re-sampling the dense control after every sub-step, accumulating
    ``judge.reward * dt``, and freezing each world's state at its first
    ``judge.is_done`` (premature out).  ``state`` may carry leading batch
    axes, each world frozen on its own.  Returns ``(final_state,
    total_reward)``.
    """
    time_per_nfe = eval_period / num_nfes
    dt = time_per_nfe / float(wfe_scale)
    device = tree_leaves(state)[0].device
    reward = torch.zeros((), device=device)
    finished = torch.tensor(False, device=device)
    for _ in range(num_nfes):
        dense_fn, _new_control = control(state)
        signal = dense_fn(state)

        end_r = torch.where(finished, reward, reward + judge.end_reward(state, signal))
        premature = (state, end_r)
        already_out = judge.is_done(state, signal)

        new_state = state
        for _i in range(wfe_scale):
            new_state = world_forward(new_state, signal, dt)
            signal = dense_fn(new_state)

            ending_reward = reward + judge.end_reward(new_state, signal)
            should_out = judge.is_done(new_state, signal) & ~already_out
            premature = tree_select(should_out, (new_state, ending_reward), premature)
            already_out = already_out | should_out

            reward = reward + judge.reward(new_state, signal) * dt

        state, reward = tree_select(already_out, premature, (new_state, reward))
        finished = already_out
    return state, reward


# ---------------------------------------------------------------------------
# Batched stepping
# ---------------------------------------------------------------------------


class BatchedEnvironmentMixin:
    """Adds ``reset_batch`` / ``step_batch`` to an Environment.

    ``step_fn_batch(states, actions)`` defaults to ``step_fn`` on the batch
    (the port of ``vmap(step_fn)``).  The four envs inherit
    ``PlaneEnvMixin`` first, whose ``reset_batch``/``step_batch`` run the
    plane-space rollout's own step.
    """

    def reset_batch(self, keys):
        return self.reset_fn_batch(keys)

    def reset_fn_batch(self, keys):
        return self.reset_fn(keys)

    def step_fn_batch(self, states, actions):
        return self.step_fn(states, actions)

    def watchdog_leaves(self, states):
        """Leaves checked by the NaN watchdog (default: the whole state)."""
        return states

    def step_batch(self, states, actions):
        """Batched step + in-graph auto-reset (batched twin of ``step``)."""
        new_states, ts = self.step_fn_batch(states, actions)
        bad = ~_all_finite(self.watchdog_leaves(new_states), 1)
        bad = bad | ~torch.isfinite(ts.reward) | ~_all_finite(ts.obs, 1)
        ts = ts._replace(
            truncated=ts.truncated | bad,
            reward=torch.where(bad, 0.0, ts.reward),
            obs=_zero_where(bad, ts.obs),
            info=_zero_where(bad, ts.info),
        )
        keys = prng.split(new_states.key)  # [B, 2, 2]
        fresh = self.reset_fn_batch(keys[:, 0])._replace(key=keys[:, 1])
        out = tree_select(ts.done, fresh, new_states._replace(key=keys[:, 1]))
        return out, ts
