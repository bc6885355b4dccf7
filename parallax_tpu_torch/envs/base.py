"""Environment API: the per-step output bundle and the base class.

The port of what the batched plane-space paths need from
``envs/base.py``: ``TimeStep`` and ``Environment``.  ``reset_batch`` and
``step_batch`` come from ``envs/plane_env.PlaneEnvMixin``, on the
rollout's own step.  The per-world ``reset``/``step`` composition,
``BatchedEnvironmentMixin`` with its ``vmap(step_fn)`` default of
``step_fn_batch``, and the continuous-time evaluation (``Control``,
``Judge``) are not ported yet (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


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


class Environment:
    """Base class: an env states its action and observation sizes and
    builds batched states with ``reset_fn_batch(keys)``."""

    @property
    def action_size(self) -> int:
        raise NotImplementedError

    @property
    def observation_size(self) -> int:
        raise NotImplementedError

    def reset_fn_batch(self, keys):
        raise NotImplementedError

