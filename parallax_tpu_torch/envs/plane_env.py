"""Generic plane-space rollout loop: one loop serves every env.

The port of ``envs/plane_env.py``.  An env inherits
:class:`PlaneEnvMixin` and defines ``plane_post`` (damping, reward,
termination) and ``plane_make_state`` (rebuild its state), and optionally
overrides ``plane_pack``, ``plane_pre``, ``plane_physics``, ``plane_obs``
and ``plane_fresh``.  Everything else is generic: the NaN watchdog,
step-limit truncation, the auto-reset key tree (``split(key) -> (reset,
carry)``), the done-merge of fresh and live planes, and chunked waves.
PyTorch runs eagerly, so ``lax.scan`` becomes a Python loop.  The same
step gives ``step_batch``, one batched step of batch-major states; it
stands in for JAX's ``BatchedEnvironmentMixin.step_batch`` over the plane
``step_fn_batch``, with the same watchdog, key tree and results, and the
envs inherit it before ``envs/base.BatchedEnvironmentMixin``'s.
``step_fn_batch`` is the raw plane step (no watchdog, no auto-reset); it
and the rollout's step share one helper, ``_plane_step``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from parallax_tpu_torch.dynamics.bodies import BodyState
from parallax_tpu_torch.engine.batched import _SoA, _from_soa, _to_soa, physics_core
from parallax_tpu_torch.envs.base import TimeStep
from parallax_tpu_torch.utils import prng
from parallax_tpu_torch.utils.pytree import tree_leaves, tree_map


class PlaneState(NamedTuple):
    """Generic batch-minor carrier: body planes + env aux + bookkeeping."""

    s: _SoA  # [n_bodies, B] body planes
    aux: Any  # env-specific NamedTuple of [..., B]-minor leaves
    t: torch.Tensor  # [B] int32
    key: torch.Tensor  # [B, 2] int64 holding uint32 key words


def init_planes_of(bodies: BodyState) -> _SoA:
    """``[n]``-shaped initial body state -> ``[n, 1]`` broadcastable planes."""
    return _SoA(
        px=bodies.pos[:, 0:1].clone(),
        py=bodies.pos[:, 1:2].clone(),
        vx=bodies.vel[:, 0:1].clone(),
        vy=bodies.vel[:, 1:2].clone(),
        angle=bodies.angle[:, None].clone(),
        omega=bodies.omega[:, None].clone(),
    )


def _where_done(done, fresh, cur):
    """Tree-select ``fresh`` where ``done``, broadcasting ``[B]`` over
    ``[..., B]`` leaves (``fresh`` leaves may be Python scalars)."""

    def f(fr, cu):
        d = done.reshape((1,) * (cu.ndim - 1) + (-1,))
        return torch.where(d, fr, cu)

    return tree_map(f, fresh, cur)


def _finite_per_world(leaf):
    """``[B]`` bool: every entry of a ``[..., B]`` leaf is finite."""
    ok = torch.isfinite(leaf)
    return ok.reshape(-1, ok.shape[-1]).all(0) if ok.ndim > 1 else ok


def _zero_where_bad(finite, x):
    if not x.is_floating_point():
        return x
    return torch.where(finite.reshape((-1,) + (1,) * (x.ndim - 1)), x, 0.0)


class PlaneEnvMixin:
    """Generic plane-space fast path; see the module docstring for hooks."""

    # -- hooks with defaults --------------------------------------------------

    def plane_pack(self, states):
        return ()

    def plane_pre(self, s: _SoA, aux, actions) -> _SoA:
        return s

    def plane_physics(self, s: _SoA, aux):
        return physics_core(self.world, s)

    def plane_obs(self, s: _SoA, aux):
        # default: every body plane, plane-major -> [B, 6 * n_bodies]
        rows = torch.stack(tuple(s))  # [6, n, B]
        return rows.reshape(-1, rows.shape[-1]).T

    def plane_fresh(self, rkeys):
        return self._init_planes, ()

    def plane_make_state(self, bodies, aux, t, key):
        raise NotImplementedError

    def plane_post(self, s, aux, con, actions, t_new):
        raise NotImplementedError

    @property
    def plane_max_steps(self) -> int:
        return self.config.max_steps

    # -- generic machinery ----------------------------------------------------

    def _to_planes(self, states) -> PlaneState:
        return PlaneState(
            s=_to_soa(states.bodies),
            aux=self.plane_pack(states),
            t=states.t,
            key=states.key,
        )

    def _from_planes(self, ps: PlaneState):
        return self.plane_make_state(_from_soa(ps.s), ps.aux, ps.t, ps.key)

    def _plane_step(self, ps: PlaneState, actions):
        """pre -> physics -> post -> obs and the step limit: the raw step
        that ``_step_planes`` and ``step_fn_batch`` share.  Returns the
        stepped planes, aux and ``t`` and a ``TimeStep`` whose ``truncated``
        is the step limit alone."""
        s = self.plane_pre(ps.s, ps.aux, actions)
        s, con = self.plane_physics(s, ps.aux)
        t_new = ps.t + 1
        s, aux, reward, terminated, info = self.plane_post(
            s, ps.aux, con, actions, t_new
        )
        ts = TimeStep(
            obs=self.plane_obs(s, aux),
            reward=reward,
            terminated=terminated,
            truncated=(t_new >= self.plane_max_steps) & ~terminated,
            info=info,
        )
        return s, aux, t_new, ts

    def _step_planes(self, ps: PlaneState, actions):
        """pre -> physics -> post -> obs -> watchdog/limits -> auto-reset."""
        s, aux, t_new, ts = self._plane_step(ps, actions)

        # NaN watchdog over every body plane, every float aux plane and the
        # emitted reward and obs: a flagged world is truncated (and so
        # reset) the step the NaN appears, and its emissions are zeroed
        finite = torch.isfinite(ts.reward)
        for leaf in list(s) + [
            x for x in tree_leaves(aux) if torch.is_tensor(x) and x.is_floating_point()
        ]:
            finite = finite & _finite_per_world(leaf)
        finite = finite & torch.isfinite(ts.obs).reshape(ts.obs.shape[0], -1).all(1)
        ts = ts._replace(
            obs=_zero_where_bad(finite, ts.obs),
            reward=_zero_where_bad(finite, ts.reward),
            truncated=ts.truncated | ~finite,
            info=tree_map(lambda x: _zero_where_bad(finite, x), ts.info),
        )
        done = ts.done

        # in-graph auto-reset; key tree split(key) -> (reset, carry)
        keys = prng.split(ps.key)  # [B, 2, 2]
        rkeys, carry_keys = keys[:, 0], keys[:, 1]
        fresh_s, fresh_aux = self.plane_fresh(rkeys)
        out = PlaneState(
            s=_where_done(done, fresh_s, s),
            aux=_where_done(done, fresh_aux, aux),
            t=torch.where(done, 0, t_new),
            key=carry_keys,
        )
        return out, ts

    def reset_batch(self, keys):
        return self.reset_fn_batch(keys)

    def step_batch(self, states, actions):
        """One batched step of batch-major ``states`` through the rollout's
        own step (the watchdog and the auto-reset included):
        ``(new_states, TimeStep)``."""
        ps, ts = self._step_planes(self._to_planes(states), actions)
        return self._from_planes(ps), ts

    def step_fn_batch(self, states, actions):
        """One batched step of batch-major ``states`` in plane space, without
        the watchdog or the auto-reset: ``(new_states, TimeStep)``, the key
        unchanged and ``truncated`` the step limit alone.  The hook that
        ``BatchedEnvironmentMixin.step_batch`` builds on in the JAX package;
        a world that ``physics_core`` does not run raises ``ValueError``."""
        ps = self._to_planes(states)
        s, aux, t_new, ts = self._plane_step(ps, actions)
        return self.plane_make_state(_from_soa(s), aux, t_new, ps.key), ts

    def rollout_batch(self, states, policy_fn, n_steps, policy_params=None,
                      max_chunk=None, mesh=None, remat_steps=False,
                      traj_select=None):
        """Plane-space batched rollout: ``(final_states, TimeStep trajectory)``
        with the trajectory time-major ``[n_steps, B, ...]``.

        ``policy_fn(params, obs[B, obs_dim]) -> actions [B, act_dim]``.
        Batches larger than ``max_chunk`` (default
        ``parallel.rollout.ROLLOUT_CHUNK``) run as sequential waves.  On a
        world ``mesh`` (``parallel/mesh.py``) ``states`` is this rank's
        shard and the waves are the rank's own (``parallel.rollout.
        chunked_rollout``); the rollout makes no collective.
        ``traj_select(ts) -> tree`` filters what each step emits.
        ``remat_steps=True`` runs each step under
        ``torch.utils.checkpoint``: under autograd only the per-step carry
        is kept and the step's internals are recomputed in the backward (a
        memory against recompute trade for training; the same values).
        """
        if n_steps < 1:
            raise ValueError(f"n_steps must be positive, got {n_steps}")
        from parallax_tpu_torch.parallel.rollout import chunked_rollout

        def step(ps):
            obs = self.plane_obs(ps.s, ps.aux)
            actions = policy_fn(policy_params, obs)
            ps, ts = self._step_planes(ps, actions)
            return ps, traj_select(ts) if traj_select else ts

        def one_wave(chunk_states):
            ps = self._to_planes(chunk_states)
            traj = []
            for _ in range(n_steps):
                if remat_steps:
                    ps, out = checkpoint(step, ps, use_reentrant=False)
                else:
                    ps, out = step(ps)
                traj.append(out)
            stacked = tree_map(lambda *xs: torch.stack(xs), *traj)
            return self._from_planes(ps), stacked

        return chunked_rollout(one_wave, states, n_steps, states.t.shape[0], max_chunk, mesh)
