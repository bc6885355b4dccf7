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

On CUDA planes with autograd off, ``rollout_batch`` replays the step from
CUDA graphs (:class:`_StepGraph`): one eager warm-up step for each wave
shape, then ``_step_planes`` captured once and replayed; the policy and
its ``plane_obs`` stay eager.  ``graph_steps`` and ``eager_steps`` count
the rollout's steps each way in this process.  The kernels' launch counters
(``ops/``) count the host's calls: a captured call counts once and its
replays not at all, so the device's kernels a replayed step are read from
the profiler.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from parallax_tpu_torch.dynamics.bodies import BodyState
from parallax_tpu_torch.engine.batched import _SoA, _from_soa, _to_soa, physics_core
from parallax_tpu_torch.envs.base import TimeStep
from parallax_tpu_torch.utils import prng, profiling
from parallax_tpu_torch.utils.profiling import named
from parallax_tpu_torch.utils.pytree import tree_leaves, tree_map

# rollout steps in this process: replayed from a captured CUDA graph, and run
# eagerly (CPU planes, autograd on, each wave shape's warm-up step)
graph_steps = 0
eager_steps = 0


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


def _copy_all(dst, src):
    """``d.copy_(s)`` for each pair: one foreach copy a dtype."""
    groups = {}
    for d, x in zip(dst, src):
        ds, xs = groups.setdefault(d.dtype, ([], []))
        ds.append(d)
        xs.append(x)
    for ds, xs in groups.values():
        torch._foreach_copy_(ds, xs)


def _spec(tree):
    """What a step's graph is captured for: each leaf's shape, dtype and device."""
    return tuple((x.shape, x.dtype, x.device) for x in tree_leaves(tree))


def _graphable(ps) -> bool:
    """Whether a wave's steps can be replayed from a graph: every leaf of its
    planes is a CUDA tensor, and autograd is off."""
    return not torch.is_grad_enabled() and all(
        torch.is_tensor(x) and x.is_cuda for x in tree_leaves(ps))


class _Pieces:
    """A capture cut at every span edge: each stretch between two edges is one
    CUDA graph in a shared memory pool, and ``script`` lists the graphs and
    the edges ``(name, opening)`` in order.  A stretch that captured nothing
    is left out of the script; ``graphs`` keeps every graph, since the pool
    lives as long as any graph captured into it."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.script, self.graphs, self.graph, self.open = [], [], None, []

    def begin(self):
        self.graph = torch.cuda.CUDAGraph()
        self.graphs.append(self.graph)
        self.graph.capture_begin(pool=self.pool)

    def end(self):
        graph, self.graph = self.graph, None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            graph.capture_end()
        empty = False
        for w in caught:
            if "CUDA Graph is empty" in str(w.message):
                empty = True
            else:
                warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        if not empty:
            self.script.append(graph)

    def cut(self, name, opening):
        self.end()
        self.script.append((name, opening))
        if opening:
            self.open.append(name)
        else:
            self.open.pop()
        self.begin()

    def abort(self):
        if self.graph is not None:
            # the capture is broken already; the error that broke it is the one raised
            with contextlib.suppress(RuntimeError):
                self.graph.capture_end()
            self.graph = None


class _StepGraph:
    """The rollout step of one wave shape as CUDA graphs.

    Its first step runs eagerly on the graph's own stream (the warm-up that
    capture needs: lazy set-up, the kernels' caches); its second captures
    ``env._step_planes`` and the copy of the merged state back into the
    step's input buffers, cut at every span edge (:class:`_Pieces`), and
    every later step replays the pieces in order, each inside its span.  The
    carried state lives in ``ps``, the graph's input buffers; ``ts`` holds
    the step's emissions, overwritten by each replay."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.warm = False
        self.script = self.ps = None

    def step(self, env, ps, actions):
        """One step of ``ps`` (the graph's own buffers, or a new wave's planes,
        which are copied in): ``(planes, TimeStep)``."""
        global graph_steps, eager_steps
        if not self.warm:
            self.warm = True
            eager_steps += 1
            cur = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                out = env._step_planes(ps, actions)
            cur.wait_stream(self.stream)
            return out
        if self.script is None:
            self._capture(env, ps, actions)
        else:
            if ps is not self.ps:
                _copy_all(tree_leaves(self.ps), tree_leaves(ps))
            self.actions.copy_(actions)
        self._replay()
        graph_steps += 1
        return self.ps, self.ts

    def _capture(self, env, ps, actions):
        self.ps = tree_map(lambda x: x.clone(memory_format=torch.contiguous_format), ps)
        self.actions = actions.clone(memory_format=torch.contiguous_format)
        torch.cuda.synchronize(self.stream.device)
        pieces = _Pieces()
        # a capture ends on the stream it began on, a failed one too
        with torch.cuda.stream(self.stream):
            try:
                with profiling.edges(pieces.cut):
                    pieces.begin()
                    out, self.ts = env._step_planes(self.ps, self.actions)
                    _copy_all(tree_leaves(self.ps), tree_leaves(out))
                    pieces.end()
            except Exception as exc:
                pieces.abort()
                where = f" inside {pieces.open[-1]}" if pieces.open else ""
                raise RuntimeError(
                    f"capturing {type(env).__name__}'s rollout step (_step_planes) at "
                    f"B={ps.t.shape[0]} as CUDA graphs failed{where}: {exc}") from exc
        self.script, self.graphs = pieces.script, pieces.graphs

    def _replay(self):
        spans = []
        for item in self.script:
            if isinstance(item, tuple):
                name, opening = item
                if opening:
                    spans.append(named(name))
                    spans[-1].__enter__()
                else:
                    spans.pop().__exit__(None, None, None)
            else:
                item.replay()


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
        with named("px.pre"):
            s = self.plane_pre(ps.s, ps.aux, actions)
        with named("px.physics"):
            s, con = self.plane_physics(s, ps.aux)
        t_new = ps.t + 1
        with named("px.post"):
            s, aux, reward, terminated, info = self.plane_post(
                s, ps.aux, con, actions, t_new
            )
        with named("px.obs"):
            obs = self.plane_obs(s, aux)
        ts = TimeStep(
            obs=obs,
            reward=reward,
            terminated=terminated,
            truncated=(t_new >= self.plane_max_steps) & ~terminated,
            info=info,
        )
        return s, aux, t_new, ts

    def _step_planes(self, ps: PlaneState, actions):
        """pre -> physics -> post -> obs -> watchdog/limits -> auto-reset."""
        with named("px.step"):
            s, aux, t_new, ts = self._plane_step(ps, actions)

            # NaN watchdog over every body plane, every float aux plane and the
            # emitted reward and obs: a flagged world is truncated (and so
            # reset) the step the NaN appears, and its emissions are zeroed
            with named("px.watchdog"):
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
            with named("px.reset"):
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
        with named("px.step"):
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

        On CUDA planes with autograd off the step is replayed from CUDA
        graphs kept on the env, one set a wave shape (:class:`_StepGraph`):
        the same kernels on the same inputs, so the same bits.  The policy
        runs eagerly each step, so a change to its weights shows at once;
        the returned states and trajectory are the caller's own tensors.
        The env keeps the graphs of the wave shapes of its last call only
        (a call under autograd keeps none).  A step that cannot be captured
        raises ``RuntimeError``.
        """
        if n_steps < 1:
            raise ValueError(f"n_steps must be positive, got {n_steps}")
        from parallax_tpu_torch.parallel.rollout import chunked_rollout

        def step(ps, step_planes):
            obs = self.plane_obs(ps.s, ps.aux)
            with named("px.policy"):
                actions = policy_fn(policy_params, obs)
            ps, ts = step_planes(ps, actions)
            return ps, traj_select(ts) if traj_select else ts

        graphs = self.__dict__.setdefault("_step_graphs", {})
        used = set()

        def graphed_wave(ps):
            graph = traj = None

            def step_planes(ps, actions):
                nonlocal graph
                if graph is None:  # the wave's first step: its shape's graphs
                    key = (_spec((ps, actions)), torch.is_inference_mode_enabled())
                    used.add(key)
                    graph = graphs.get(key)
                    if graph is None:
                        graph = graphs[key] = _StepGraph(ps.t.device)
                return graph.step(self, ps, actions)

            for i in range(n_steps):
                ps, out = step(ps, step_planes)
                if traj is None:
                    traj = tree_map(lambda x: x.new_empty((n_steps,) + x.shape), out)
                _copy_all([x[i] for x in tree_leaves(traj)], tree_leaves(out))
            if ps is graph.ps:  # the graph's buffers: the caller gets copies
                ps = tree_map(torch.clone, ps)
            return ps, traj

        def one_wave(chunk_states):
            global eager_steps
            with named("px.rollout"):
                ps = self._to_planes(chunk_states)
                if _graphable(ps):
                    ps, stacked = graphed_wave(ps)
                    return self._from_planes(ps), stacked
                traj = []
                for _ in range(n_steps):
                    if remat_steps:
                        ps, out = checkpoint(step, ps, self._step_planes, use_reentrant=False)
                    else:
                        ps, out = step(ps, self._step_planes)
                    traj.append(out)
                stacked = tree_map(lambda *xs: torch.stack(xs), *traj)
                eager_steps += n_steps
                return self._from_planes(ps), stacked

        out = chunked_rollout(one_wave, states, n_steps, states.t.shape[0], max_chunk, mesh)
        for key in graphs.keys() - used:  # their pools go back to the allocator
            del graphs[key]
        return out
