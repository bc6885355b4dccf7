"""Carry states and contact buffers between numpy and the port.

The rollout has no learned weights: these functions are how a state taken
elsewhere (for example a JAX state read with ``np.asarray``) enters the
port, and how the port's state leaves it.  Keys are uint32 in numpy and
int64 holding uint32 words in the port (see ``utils/prng.py``).  Like
every entry point of the port they put their tensors on the GPU unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parallax_tpu_torch.dynamics.bodies import BodyParams, BodyState
from parallax_tpu_torch.engine.batched import ContactsBM, _SoA
from parallax_tpu_torch.utils.device import resolve as resolve_device


def _f32(x, device):
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _bodies(d: dict, device) -> BodyState:
    return BodyState(*(_f32(d[f"bodies.{f}"], device) for f in BodyState._fields))


def _key(d: dict, device):
    key = np.asarray(d["key"])
    if key.dtype != np.uint32:
        raise ValueError(f"key must be uint32, got {key.dtype}")
    return torch.tensor(key.astype(np.int64), device=device)


def lander_state_from_numpy(d: dict, device="cuda"):
    """``{field: array}`` -> ``LanderState``.  The fields are
    ``bodies.pos``, ``bodies.vel``, ``bodies.angle``, ``bodies.omega``,
    ``terrain``, ``t``, ``key`` (uint32), ``prev_shaping`` and
    ``leg_contacts``."""
    from parallax_tpu_torch.envs.lunar_lander import LanderState

    device = resolve_device(device)
    return LanderState(
        bodies=_bodies(d, device),
        terrain=_f32(d["terrain"], device),
        t=torch.tensor(np.asarray(d["t"], np.int32), device=device),
        key=_key(d, device),
        prev_shaping=_f32(d["prev_shaping"], device),
        leg_contacts=_f32(d["leg_contacts"], device),
    )


def lander_state_to_numpy(state) -> dict:
    """``LanderState`` -> ``{field: array}`` (the fields of
    :func:`lander_state_from_numpy`)."""
    b = state.bodies

    def a(x):
        return x.detach().cpu().numpy()

    return {
        "bodies.pos": a(b.pos),
        "bodies.vel": a(b.vel),
        "bodies.angle": a(b.angle),
        "bodies.omega": a(b.omega),
        "terrain": a(state.terrain),
        "t": a(state.t),
        "key": a(state.key).astype(np.uint32),
        "prev_shaping": a(state.prev_shaping),
        "leg_contacts": a(state.leg_contacts),
    }


def robocup_state_from_numpy(d: dict, device="cuda"):
    """``{field: array}`` -> ``RoboCupState``.  The fields are
    ``bodies.pos``, ``bodies.vel``, ``bodies.angle``, ``bodies.omega``,
    ``t`` and ``key`` (uint32)."""
    from parallax_tpu_torch.envs.robocup import RoboCupState

    device = resolve_device(device)
    return RoboCupState(
        bodies=_bodies(d, device),
        t=torch.tensor(np.asarray(d["t"], np.int32), device=device),
        key=_key(d, device),
    )


def robocup_state_to_numpy(state) -> dict:
    """``RoboCupState`` -> ``{field: array}`` (the fields of
    :func:`robocup_state_from_numpy`)."""
    out = {f"bodies.{f}": x.detach().cpu().numpy()
           for f, x in zip(BodyState._fields, state.bodies)}
    out["t"] = state.t.detach().cpu().numpy()
    out["key"] = state.key.detach().cpu().numpy().astype(np.uint32)
    return out


def bouncer_state_from_numpy(d: dict, device="cuda"):
    """``{field: array}`` -> ``BouncerState``.  The fields are
    ``bodies.pos``, ``bodies.vel``, ``bodies.angle``, ``bodies.omega``,
    ``t`` and ``key`` (uint32)."""
    from parallax_tpu_torch.envs.bouncer import BouncerState

    return BouncerState(*robocup_state_from_numpy(d, device))


def bouncer_state_to_numpy(state) -> dict:
    """``BouncerState`` -> ``{field: array}`` (the fields of
    :func:`bouncer_state_from_numpy`)."""
    return robocup_state_to_numpy(state)


def billiards_state_from_numpy(d: dict, device="cuda"):
    """``{field: array}`` -> ``BilliardsState``.  The fields are
    ``bodies.pos``, ``bodies.vel``, ``bodies.angle``, ``bodies.omega``,
    ``potted`` (bool), ``t`` and ``key`` (uint32)."""
    from parallax_tpu_torch.envs.billiards import BilliardsState

    bodies, t, key = robocup_state_from_numpy(d, device)
    potted = torch.tensor(np.asarray(d["potted"], bool), device=t.device)
    return BilliardsState(bodies=bodies, potted=potted, t=t, key=key)


def billiards_state_to_numpy(state) -> dict:
    """``BilliardsState`` -> ``{field: array}`` (the fields of
    :func:`billiards_state_from_numpy`)."""
    out = robocup_state_to_numpy(state)
    out["potted"] = state.potted.detach().cpu().numpy()
    return out


def body_state_from_numpy(d, device="cuda") -> BodyState:
    """``{pos, vel, angle, omega}`` arrays (a dict, or anything with those
    attributes, such as the JAX package's ``BodyState`` read with
    ``np.asarray``) with any leading axes -> ``BodyState`` float32."""
    device = resolve_device(device)
    get = d.__getitem__ if isinstance(d, dict) else lambda f: getattr(d, f)
    return BodyState(*(_f32(get(f), device) for f in BodyState._fields))


def body_state_to_numpy(state: BodyState) -> dict:
    """``BodyState`` -> ``{pos, vel, angle, omega}`` numpy arrays."""
    return {f: x.detach().cpu().numpy() for f, x in zip(BodyState._fields, state)}


# the differentiable leaves of a world: (field of World, its fields)
WORLD_LEAVES = (
    ("params", BodyParams._fields),
    ("joints", ("anchor_a", "anchor_b", "kp", "kd", "v0")),
    ("parts", ("verts", "radius")),
)


def world_leaves_from_numpy(world, d: dict):
    """The port's ``world`` with its differentiable leaves replaced by the
    arrays of ``d``, keyed ``"params.mass"``, ``"params.inertia"``,
    ``"params.elasticity"``, ``"params.friction"``, ``"joints.anchor_a"``,
    ``"joints.anchor_b"``, ``"joints.kp"``, ``"joints.kd"``,
    ``"joints.v0"``, ``"parts.verts"`` and ``"parts.radius"`` (the leaves
    of the JAX package's ``World``; a missing key keeps the world's own
    leaf).  The topology stays; the static tables of the batched step are
    rebuilt from the new leaves, on the world's device."""
    from parallax_tpu_torch.engine.batched import build_static_tables

    new = {}
    for field, leaves in WORLD_LEAVES:
        old = getattr(world, field)
        repl = {f: _f32(d[f"{field}.{f}"], world.device) for f in leaves if f"{field}.{f}" in d}
        new[field] = (old._replace(**repl) if hasattr(old, "_replace")
                      else dataclasses.replace(old, **repl))
    out = dataclasses.replace(world, cache={}, **new)
    build_static_tables(out)
    return out


def soa_from_numpy(planes, device="cuda") -> _SoA:
    """Six ``[n, B]`` arrays (a sequence or anything with the ``_SoA`` field
    names as attributes) -> ``_SoA``."""
    device = resolve_device(device)
    if hasattr(planes, "px"):
        planes = [getattr(planes, f) for f in _SoA._fields]
    return _SoA(*(_f32(x, device) for x in planes))


def contacts_from_numpy(con, device="cuda") -> ContactsBM:
    """Six ``[C, B]`` arrays (``ContactsBM`` field order or attributes) ->
    ``ContactsBM``; ``active`` becomes bool."""
    device = resolve_device(device)
    if hasattr(con, "pen_x"):
        con = [getattr(con, f) for f in ContactsBM._fields]
    pen_x, pen_y, pt_x, pt_y, active, weight = con
    return ContactsBM(
        pen_x=_f32(pen_x, device),
        pen_y=_f32(pen_y, device),
        pt_x=_f32(pt_x, device),
        pt_y=_f32(pt_y, device),
        active=torch.tensor(np.asarray(active, bool), device=device),
        weight=_f32(weight, device),
    )


def to_numpy(tree):
    """Tensors of a NamedTuple (or a single tensor) -> numpy arrays."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    return type(tree)(*(to_numpy(x) for x in tree))
