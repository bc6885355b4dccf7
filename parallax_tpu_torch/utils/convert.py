"""Carry states and contact buffers between numpy and the port.

The rollout has no learned weights: these functions are how a state taken
elsewhere (for example a JAX state read with ``np.asarray``) enters the
port, and how the port's state leaves it.  Keys are uint32 in numpy and
int64 holding uint32 words in the port (see ``utils/prng.py``).  Like
every entry point of the port they put their tensors on the GPU unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from parallax_tpu_torch.dynamics.bodies import BodyState
from parallax_tpu_torch.engine.batched import ContactsBM, _SoA
from parallax_tpu_torch.utils.device import resolve as resolve_device


def _f32(x, device):
    return torch.tensor(np.asarray(x, np.float32), device=device)


def lander_state_from_numpy(d: dict, device="cuda"):
    """``{field: array}`` -> ``LanderState``.  The fields are
    ``bodies.pos``, ``bodies.vel``, ``bodies.angle``, ``bodies.omega``,
    ``terrain``, ``t``, ``key`` (uint32), ``prev_shaping`` and
    ``leg_contacts``."""
    from parallax_tpu_torch.envs.lunar_lander import LanderState

    device = resolve_device(device)
    key = np.asarray(d["key"])
    if key.dtype != np.uint32:
        raise ValueError(f"key must be uint32, got {key.dtype}")
    return LanderState(
        bodies=BodyState(
            pos=_f32(d["bodies.pos"], device),
            vel=_f32(d["bodies.vel"], device),
            angle=_f32(d["bodies.angle"], device),
            omega=_f32(d["bodies.omega"], device),
        ),
        terrain=_f32(d["terrain"], device),
        t=torch.tensor(np.asarray(d["t"], np.int32), device=device),
        key=torch.tensor(key.astype(np.int64), device=device),
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
