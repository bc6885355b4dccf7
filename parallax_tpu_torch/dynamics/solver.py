"""Contact solvers over fixed-shape contact buffers (the torch port of
``dynamics/solver.py``), on contacts with leading batch axes:

* ``jacobi``       -- K sweeps; every contact computes its impulse against
                      the current velocities, the deltas (scaled by
                      ``relaxation`` and the lane's weight) summed per body;
* ``gauss_seidel`` -- K sequential sweeps over the contact buffer, in
                      buffer order;
* ``random_one_per_body`` -- the reference's policy: each body picks one
                      random active contact involving it, then the bodies
                      are resolved one after another in index order.

All modes use the reference impulse math of ``dynamics.impulses``.  The
sequential modes are Python loops over lanes or bodies (``lax.scan`` in
the JAX package), each step a few small ops over the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from parallax_tpu_torch.dynamics.block_solver import segment_sum
from parallax_tpu_torch.dynamics.bodies import BodyParams, BodyState
from parallax_tpu_torch.dynamics.impulses import (
    DEFAULT_SOLVER,
    ContactSolverConfig,
    resolve_contact_deltas,
)
from parallax_tpu_torch.geometry.contacts import Contact
from parallax_tpu_torch.utils import prng
from parallax_tpu_torch.utils.device import static_tensor


def _params_tuple(params: BodyParams):
    return (params.inv_mass, params.inv_inertia, params.elasticity, params.friction)


def _gather_params(params: BodyParams, idx):
    return tuple(x[..., idx] for x in _params_tuple(params))


def resolve_contacts(
    state: BodyState,
    params: BodyParams,
    contacts: Contact,
    body_a: np.ndarray,
    body_b: np.ndarray,
    mode: str = "jacobi",
    iterations: int = 4,
    relaxation: float = 1.0,
    key=None,
    config: ContactSolverConfig = DEFAULT_SOLVER,
) -> BodyState:
    """Apply contact impulses; returns the state with updated vel/omega.

    ``contacts`` holds ``[.., C]`` contact lanes; ``body_a``/``body_b`` are
    static int vectors of length C mapping lanes to bodies.  ``key`` (the
    random mode's) is ``[.., 2]``, one threefry key a world.
    """
    if len(body_a) == 0:
        return state

    if mode == "jacobi":
        dev = state.pos.device
        n = state.pos.shape[-2]
        ia = static_tensor(body_a, dev)
        ib = static_tensor(body_b, dev)
        for _ in range(iterations):
            (dva, dwa), (dvb, dwb), _ = resolve_contact_deltas(
                contacts.penetration, contacts.point, contacts.active,
                state.pos[..., ia, :], state.vel[..., ia, :], state.omega[..., ia],
                state.pos[..., ib, :], state.vel[..., ib, :], state.omega[..., ib],
                _gather_params(params, ia), _gather_params(params, ib),
                config,
            )
            r = relaxation * contacts.weight
            dva = dva * r[..., None]
            dvb = dvb * r[..., None]
            dwa = dwa * r
            dwb = dwb * r
            dvel = segment_sum(dva, ia, n, -2) + segment_sum(dvb, ib, n, -2)
            domega = segment_sum(dwa, ia, n, -1) + segment_sum(dwb, ib, n, -1)
            state = state._replace(vel=state.vel + dvel, omega=state.omega + domega)
        return state

    if mode == "gauss_seidel":
        # the lanes in buffer order; the bodies' columns are carried apart,
        # so each lane touches only its two bodies
        vel = list(state.vel.unbind(-2))
        omega = list(state.omega.unbind(-1))
        pos = state.pos.unbind(-2)
        ptup = _params_tuple(params)
        pen, point = contacts.penetration.unbind(-2), contacts.point.unbind(-2)
        active, weight = contacts.active.unbind(-1), contacts.weight.unbind(-1)
        for _ in range(iterations):
            for c, (a, b) in enumerate(zip(body_a, body_b)):
                a, b = int(a), int(b)
                (dva, dwa), (dvb, dwb), _ = resolve_contact_deltas(
                    pen[c], point[c], active[c],
                    pos[a], vel[a], omega[a], pos[b], vel[b], omega[b],
                    tuple(x[a] for x in ptup), tuple(x[b] for x in ptup),
                    config,
                )
                w = weight[c]
                vel[a] = vel[a] + dva * w[..., None]
                vel[b] = vel[b] + dvb * w[..., None]
                omega[a] = omega[a] + dwa * w
                omega[b] = omega[b] + dwb * w
        return state._replace(vel=torch.stack(vel, -2), omega=torch.stack(omega, -1))

    if mode == "random_one_per_body":
        return _resolve_random_one_per_body(state, params, contacts, body_a, body_b, key, config)

    raise ValueError(f"unknown solver mode {mode!r}")


def _membership(body_a, body_b, n: int):
    """Static ``[n, C]`` masks: lane c's A side (B side) is body i."""
    C = len(body_a)
    mem_a = np.zeros((n, C), dtype=bool)
    mem_b = np.zeros((n, C), dtype=bool)
    mem_a[np.asarray(body_a), np.arange(C)] = True
    mem_b[np.asarray(body_b), np.arange(C)] = True
    return mem_a, mem_b


def choose_lanes(contacts: Contact, body_a, body_b, n: int, key):
    """Each body's uniformly random active lane: ``(choice [.., n], has_any
    [.., n])``.  JAX's ``categorical`` over ``split(key, n)``, one key a
    body, on logits 0 for the body's active lanes and -inf elsewhere;
    ``has_any`` is whether the body has an active lane at all."""
    mem_a, mem_b = _membership(body_a, body_b, n)
    cand = static_tensor(mem_a | mem_b, contacts.active.device) & contacts.active[..., None, :]
    logits = torch.where(cand, 0.0, float("-inf"))
    keys = prng.split(key, n)  # [.., n, 2]
    return prng.categorical(keys, logits), cand.any(-1)


def _resolve_random_one_per_body(
    state: BodyState,
    params: BodyParams,
    contacts: Contact,
    body_a: np.ndarray,
    body_b: np.ndarray,
    key,
    config: ContactSolverConfig,
) -> BodyState:
    """The reference's randomized collider policy.

    For each body i: uniformly choose one active contact involving i (if
    any), then resolve the chosen contacts in body order, each oriented so
    that body i is "body1".  The chosen lane and its other body differ from
    world to world, so they are gathered per world and the other body's
    deltas added through a one-hot row (JAX's ``_add_at2``/``_add_at1``).
    """
    n = state.pos.shape[-2]
    dev = state.pos.device
    batch = contacts.active.shape[:-1]
    if key is None:
        key = torch.zeros(batch + (2,), dtype=torch.int64, device=dev)  # PRNGKey(0)
    choice, has_any = choose_lanes(contacts, body_a, body_b, n, key)
    mem_a = static_tensor(_membership(body_a, body_b, n)[0], dev)
    ta = static_tensor(body_a, dev)
    tb = static_tensor(body_b, dev)
    rows = static_tensor(np.arange(n), dev)
    ptup = _params_tuple(params)
    eye = static_tensor(np.eye(n, dtype=np.float32), dev).to(state.vel.dtype)

    vel, omega = state.vel, state.omega
    for i in range(n):
        c = choice[..., i]  # the chosen lane of body i
        pen = _take2(contacts.penetration, c)
        point = _take2(contacts.point, c)
        act = _take1(contacts.active, c) & has_any[..., i]
        i_is_a = mem_a[i][c]
        # orient so that body1 is i
        j_idx = torch.where(i_is_a, tb[c], ta[c])
        pen = torch.where(i_is_a[..., None], pen, -pen)
        (dva, dwa), (dvb, dwb), _ = resolve_contact_deltas(
            pen, point, act,
            state.pos[..., i, :], vel[..., i, :], omega[..., i],
            _take2(state.pos, j_idx), _take2(vel, j_idx), _take1(omega, j_idx),
            tuple(x[i] for x in ptup), tuple(x[j_idx] for x in ptup),
            config,
        )
        vel = vel.index_add(-2, rows[i:i + 1], dva[..., None, :])
        omega = omega.index_add(-1, rows[i:i + 1], dwa[..., None])
        onehot = eye[j_idx]  # [.., n]
        vel = vel + onehot[..., None] * dvb[..., None, :]
        omega = omega + onehot * dwb[..., None]
    return state._replace(vel=vel, omega=omega)


def _take2(x, idx):
    """``x [.., n, 2]`` gathered at a per-world index ``idx [..]`` -> ``[.., 2]``."""
    x = x.expand(*idx.shape, *x.shape[-2:])
    return torch.take_along_dim(x, idx[..., None, None], dim=-2)[..., 0, :]


def _take1(x, idx):
    """``x [.., n]`` gathered at a per-world index ``idx [..]`` -> ``[..]``."""
    x = x.expand(*idx.shape, x.shape[-1])
    return torch.take_along_dim(x, idx[..., None], dim=-1)[..., 0]
