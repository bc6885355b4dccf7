"""Rollouts and the differentiable-physics train step (one device).

The port of ``parallel/rollout.py``'s ``ROLLOUT_CHUNK``, the single-device
path of ``chunked_rollout``, the per-world ``rollout``, ``batched_rollout``
(the plane-space fast path, else ``rollout`` on the batch, the port of
its ``vmap`` fallback) and ``make_train_step``.  ``jax.checkpoint`` becomes
``torch.utils.checkpoint`` (non-reentrant), ``lax.scan`` a Python loop and
``optax.adam`` ``torch.optim.Adam`` with optax's defaults.  The mesh path
(ROADMAP Queue 1 item 9) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from parallax_tpu_torch.utils.pytree import tree_map

# World-batch size of one rollout wave: larger fleets run as sequential
# waves of this size.  (The value is the JAX package's; it has not been
# re-tuned for the GPU.)
ROLLOUT_CHUNK = 8192


def chunked_rollout(rollout_fn: Callable, states, batch: int,
                    max_chunk: Optional[int] = None):
    """Run a batched rollout in sequential ``max_chunk``-sized waves.

    ``rollout_fn(states_chunk) -> (final_chunk, traj_chunk)`` with the traj
    time-major ``[T, Bc, ...]``.  Worlds are independent, so splitting the
    batch is exact.  A batch that is not a multiple of the chunk runs its
    full waves plus one remainder wave.  ``max_chunk=0`` disables chunking.
    """
    chunk = ROLLOUT_CHUNK if max_chunk is None else max_chunk
    if not chunk or batch <= chunk:
        return rollout_fn(states)
    finals, trajs = [], []
    for start in range(0, batch, chunk):
        wave = tree_map(lambda x: x[start:start + chunk], states)
        final, traj = rollout_fn(wave)
        finals.append(final)
        trajs.append(traj)
    final = tree_map(lambda *xs: torch.cat(xs, dim=0), *finals)
    traj = tree_map(lambda *xs: torch.cat(xs, dim=1), *trajs)
    return final, traj


def _check_segments(n_steps: int, checkpoint_segments: int) -> None:
    if checkpoint_segments and n_steps % checkpoint_segments != 0:
        # a silent fallback here once cost the JAX package an out-of-memory
        # on a horizon-100 lander backward pass: reject loudly instead
        raise ValueError(
            f"checkpoint_segments={checkpoint_segments} must divide "
            f"n_steps={n_steps}"
        )


def _segments(run, state, n_steps: int, checkpoint_segments: int):
    """``run(state, steps) -> (state, traj)`` over ``n_steps``, or as
    ``checkpoint_segments`` segments each under ``torch.utils.checkpoint``
    (under autograd only the segment boundaries are kept and each segment
    is recomputed in the backward); the trajectories joined time-major."""
    _check_segments(n_steps, checkpoint_segments)
    if not checkpoint_segments:
        return run(state, n_steps)
    seg = n_steps // checkpoint_segments
    trajs = []
    for _ in range(checkpoint_segments):
        state, traj = checkpoint(run, state, seg, use_reentrant=False)
        trajs.append(traj)
    return state, tree_map(lambda *xs: torch.cat(xs, dim=0), *trajs)


def rollout(env, state, policy_fn: Callable, policy_params, n_steps: int,
            checkpoint_segments: int = 0):
    """Roll a policy for ``n_steps`` through ``env.step`` (per world, any
    leading batch axes): ``(final_state, TimeStep trajectory)``, the
    trajectory time-major ``[n_steps, ...]``.

    ``policy_fn(params, obs) -> action``.  With ``checkpoint_segments > 0``
    the loop runs as that many segments under ``torch.utils.checkpoint``,
    so reverse-mode memory scales with the segment count, not the steps.
    """

    def run(state, steps):
        tss = []
        for _ in range(steps):
            action = policy_fn(policy_params, env.observe(state))
            state, ts = env.step(state, action)
            tss.append(ts)
        return state, tree_map(lambda *xs: torch.stack(xs), *tss)

    return _segments(run, state, n_steps, checkpoint_segments)


def batched_rollout(env, states, policy_fn, policy_params, n_steps,
                    checkpoint_segments=0, max_chunk=None, mesh=None,
                    remat_steps=False, traj_select=None):
    """Batched rollout: ``(final_states, trajectory)``, the trajectory
    time-major ``[n_steps, B, ...]``.  It runs the env's plane-space fast
    path (``env.rollout_batch``) where the env has one, else
    :func:`rollout` on the batch (the port of JAX's ``vmap`` fallback),
    with ``traj_select`` applied after the fact.

    With ``checkpoint_segments > 0`` the rollout runs as that many segments,
    each under ``torch.utils.checkpoint``: under autograd only the segment
    boundaries are kept and each segment is recomputed in the backward.
    ``remat_steps`` additionally checkpoints each step inside a segment
    (see ``PlaneEnvMixin.rollout_batch``)."""
    _check_segments(n_steps, checkpoint_segments)
    fast = getattr(env, "rollout_batch", None)
    if fast is None:
        if max_chunk or mesh is not None or remat_steps:
            # the fallback has no wave machinery: running one giant wave
            # where the caller asked for waves would be a silent change
            raise ValueError(
                "max_chunk/mesh/remat_steps require the plane-space fast path "
                "(env.rollout_batch); this env only has the per-world fallback"
            )
        final, tss = rollout(env, states, policy_fn, policy_params, n_steps,
                             checkpoint_segments)
        return final, traj_select(tss) if traj_select is not None else tss

    def run(s, steps):
        return fast(s, policy_fn, steps, policy_params, max_chunk=max_chunk,
                    mesh=mesh, remat_steps=remat_steps, traj_select=traj_select)

    return _segments(run, states, n_steps, checkpoint_segments)


def adam(params: dict, lr: float = 3e-3) -> torch.optim.Adam:
    """``torch.optim.Adam`` over ``params``' tensors with optax.adam's
    defaults (b1 0.9, b2 0.999, eps 1e-8); the update is the same formula."""
    return torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def make_loss_fn(env, policy_fn: Callable, n_steps: int,
                 checkpoint_segments: int = 0, discount: float = 0.99,
                 max_chunk: Optional[int] = None, mesh=None,
                 remat_steps: bool = False):
    """The train step's loss: ``loss_fn(params, states) -> (loss, (final,
    mean_return))``, ``loss`` the negated mean discounted return of an
    ``n_steps`` rollout, differentiable in ``params`` through the physics."""
    if mesh is not None:
        raise NotImplementedError(
            "training over a device mesh is not ported yet (ROADMAP Queue 1 "
            "item 9)"
        )

    def loss_fn(params, states):
        # stack only the reward plane: the loss reads nothing else
        final, rewards = batched_rollout(
            env, states, policy_fn, params, n_steps, checkpoint_segments,
            max_chunk=max_chunk, remat_steps=remat_steps,
            traj_select=lambda ts: ts.reward,
        )
        disc = discount ** torch.arange(
            n_steps, dtype=torch.float32, device=rewards.device
        )
        ret = torch.sum(rewards * disc[:, None], dim=0)  # [B]
        return -torch.mean(ret), (final, torch.mean(ret))

    return loss_fn


def make_train_step(env, policy_fn: Callable, optimizer: torch.optim.Optimizer,
                    n_steps: int, checkpoint_segments: int = 0,
                    discount: float = 0.99, max_chunk: Optional[int] = None,
                    mesh=None, remat_steps: bool = False):
    """Differentiable-physics policy-gradient train step.

    ``optimizer`` holds ``params``' tensors (see :func:`adam`) and their
    state.  Returns ``train_step(params, states) -> (params, final_states,
    metrics)``: one rollout of ``n_steps``, the backward through it, and one
    optimizer update of ``params`` in place.  ``metrics`` holds ``loss``
    and ``mean_return``; the final states are detached, ready for the next
    step.  A loss that does not depend on ``params`` (an env whose reward
    has no gradient path, like billiards' pot counts) gets zero gradients,
    as from ``jax.value_and_grad``, and the update steps with them."""
    loss_fn = make_loss_fn(env, policy_fn, n_steps, checkpoint_segments,
                           discount, max_chunk, mesh, remat_steps)

    def train_step(params, states):
        optimizer.zero_grad(set_to_none=True)
        loss, (final, mean_ret) = loss_fn(params, states)
        if loss.requires_grad:
            loss.backward()
        else:
            for p in params.values():
                p.grad = torch.zeros_like(p)
        optimizer.step()
        final = tree_map(torch.Tensor.detach, final)
        return params, final, {"loss": loss.detach(), "mean_return": mean_ret.detach()}

    return train_step
