"""The fused physics step: CUDA kernel, wrapper and plain version.

``csrc/fused_step.cu`` replaces ``parallax_tpu/ops/pallas_step.py``'s
``_step_kernel`` for worlds whose pair groups are all polygon-polygon
(``pp``): one launch runs integration and gravity, the world-frame
vertices (with the per-world terrain override), the SAT manifolds, the
contact solve and the joints, one CUDA thread per world.  The contact
geometry stays inside the kernel; it returns the body planes and the
``[C, B]`` active flags.  Its plain version, :func:`fused_step_plain`, is
the split step of ``engine.batched`` with the plain solver.

:func:`physics_core_fused` chooses by the tensors' device and nothing
else: on CPU tensors it runs the plain version (autograd of its plain ops
is the backward); on CUDA tensors it checks the world and the planes and
launches the kernel.  A world the kernel does not run, a failing build or
a failing launch raises.  The kernel's reverse pass is not ported yet, so
on CUDA tensors under autograd it raises too (ROADMAP Queue 2 item 4):
there is no silent split path.  ``launches`` counts the kernel's launches;
only the launch itself adds to it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from parallax_tpu_torch.geometry.shapes import BOX, MAX_VERTS, edge_mask_for

# kernel launches in this process (see module docstring)
launches = 0

# pair-group kernels the fused kernel runs; the JAX kernel's circle and box
# lanes (cc, cb, bb, area_cb) come with RoboCup and billiards
FUSED_KERNELS = ("pp",)


def supports_fused_step(world) -> bool:
    """Whether the fused kernel runs ``world``: its pair groups are all in
    ``FUSED_KERNELS``, the solver is the block solver, and a world with a
    ``pp`` group has the broadphase off (the kernel has no AABB pre-mask;
    the rule of ``pallas_step.py:84``)."""
    kernels = {g.kernel for g in world.table.groups}
    if not kernels <= set(FUSED_KERNELS):
        return False
    if world.config.solver_mode != "block":
        return False
    return "pp" not in kernels or not world.config.broadphase


def check_fused_step(world) -> None:
    """Raise, saying why, unless :func:`supports_fused_step` holds."""
    from parallax_tpu_torch.engine.batched import check_batched_support

    check_batched_support(world.config, "the fused step")
    unported = sorted({g.kernel for g in world.table.groups} - set(FUSED_KERNELS))
    if unported:
        raise NotImplementedError(
            f"the fused step kernel runs {FUSED_KERNELS} pair groups; "
            f"{unported} are not ported yet (ROADMAP Queue 1 item 8)"
        )
    if world.config.broadphase:
        raise ValueError(
            "the fused step kernel has no AABB pre-mask stage: build the "
            "world with broadphase=False"
        )


class FusedOperands(NamedTuple):
    """Static kernel inputs of the step's geometry, on the world's device
    (the counterpart of ``_static_step_info``).  The terrain override is a
    per-call argument: the kernel reads the k-th overridden part, in
    ``sorted(override)`` order as at ``pallas_step.py:158``, from rows
    ``k * MAX_VERTS ...`` of the terrain planes."""

    part_i: torch.Tensor  # [P, 3] int32: owning body, rotates, vertices read
    part_lv: torch.Tensor  # [P, MAX_VERTS, 2] f32 local vertices
    pair_i: torch.Tensor  # [pairs, 6] int32: parts a, b, Va, Vb, edge-mask bits


def fused_operands(world) -> FusedOperands:
    """Built once per world: each part's body, rotate flag and the number of
    vertices its groups read (their trimmed ``Va``/``Vb``), and per pair of
    the table, in lane order, its parts, trimmed vertex counts and edge
    masks (``engine.batched._group_masks``) as bits."""

    def build():
        parts = world.parts
        P = len(parts.nverts)
        nv = np.zeros(P, np.int32)
        pairs = []
        for g in world.table.groups:
            Va = max(parts.nverts[i] for i in g.part_a)
            Vb = max(parts.nverts[i] for i in g.part_b)
            for a, b in zip(g.part_a, g.part_b):
                nv[a] = max(nv[a], Va)
                nv[b] = max(nv[b], Vb)
                ma = edge_mask_for(parts.nverts[a], Va)
                mb = edge_mask_for(parts.nverts[b], Vb)
                pairs.append([a, b, Va, Vb, _bits(ma), _bits(mb)])
        rotate = [int(k != BOX) for k in parts.kind]
        part_i = np.stack([np.asarray(parts.body), rotate, nv], axis=1).astype(np.int32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(world.device)

        return FusedOperands(
            part_i=t(part_i),
            part_lv=parts.verts.to(torch.float32).contiguous().to(world.device),
            pair_i=t(np.asarray(pairs, np.int32).reshape(-1, 6)),
        )

    return world.static(("fused_operands",), build)


def _bits(mask) -> int:
    return int(sum(1 << v for v, on in enumerate(mask) if on))


# ---------------------------------------------------------------------------
# plain version, wrapper, launch
# ---------------------------------------------------------------------------


def _exported(active):
    """The contact buffer the fused step exports: only ``active``; the
    geometry planes are zeros and the weights ones (``pallas_step.py:760``)."""
    from parallax_tpu_torch.engine.batched import ContactsBM

    zero = torch.zeros(active.shape, dtype=torch.float32, device=active.device)
    return ContactsBM(
        pen_x=zero, pen_y=zero, pt_x=zero, pt_y=zero, active=active,
        weight=torch.ones_like(zero),
    )


def fused_step_plain(world, s, terrain_override=None, dt=None, accel=None):
    """The kernel's plain version: the split step of ``engine.batched``
    (``integrate_bm``, ``collide_batched``, ``solve_contacts_bm``,
    ``apply_joints_bm``), with one rule of the fused step's: a pair with no
    valid axis is inactive.  Returns ``(_SoA, ContactsBM)`` with only
    ``active`` exported, as the kernel's wrapper does."""
    from parallax_tpu_torch.engine.batched import collide_batched, integrate_bm
    from parallax_tpu_torch.ops.contact_solver import solve_contacts_plain

    cfg = world.config
    s, dt = integrate_bm(world, s, dt, accel)
    con = collide_batched(world, s, terrain_override, inactive_without_axis=True)
    s = solve_contacts_plain(
        world, s, con, cfg.solver_iterations, cfg.position_iterations, dt, cfg.contact
    )
    return s, _exported(con.active)


def physics_core_fused(world, s, terrain_override=None, dt=None, accel=None):
    """The fused step: the kernel on CUDA tensors, the plain version on CPU
    tensors.  ``terrain_override`` is ``{part: ([MAX_VERTS, B] x, y)}`` of
    world-frame vertex planes.  Returns ``(_SoA, ContactsBM)``."""
    device = s.px.device
    if device.type == "cpu":
        return fused_step_plain(world, s, terrain_override, dt, accel)
    if device.type != "cuda":
        raise ValueError(f"fused step: no kernel for device {device}")
    check_fused_step(world)
    override = terrain_override or {}
    inputs = (*s, *(x for xy in override.values() for x in xy))
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        raise NotImplementedError(
            "the fused step kernel has no reverse pass yet (ROADMAP Queue 2 "
            "item 4); train with use_cuda_fused=False"
        )
    return _step_cuda(world, s, override, dt, accel)


def _step_cuda(world, s, override, dt, accel):
    global launches
    from parallax_tpu_torch.ops import _build
    from parallax_tpu_torch.ops.contact_solver import _check, _ptr, _tail, solver_operands

    lib = _build.load()
    cfg = world.config
    device = s.px.device
    C = world.table.n_contacts
    n, B = s.px.shape
    if n > lib.contact_solver_max_bodies():
        raise ValueError(f"fused step kernel: {n} bodies, at most {lib.contact_solver_max_bodies()}")
    P = len(world.parts.nverts)
    if P > lib.fused_step_max_parts():
        raise ValueError(f"fused step kernel: {P} parts, at most {lib.fused_step_max_parts()}")
    for name, x in zip(s._fields, s):
        _check(name, x, (n, B), torch.float32, device)
    tparts = sorted(override)
    for p in tparts:
        for name, x in zip(("x", "y"), override[p]):
            _check(f"terrain_override[{p}] {name}", x, (MAX_VERTS, B), torch.float32, device)
    if tparts:
        tx = torch.cat([override[p][0] for p in tparts])
        ty = torch.cat([override[p][1] for p in tparts])
    else:
        tx = ty = torch.empty((0, B), dtype=torch.float32, device=device)
    sops = solver_operands(world, cfg.contact)
    fops = fused_operands(world)
    for name, x in (*zip(sops._fields, sops), *zip(fops._fields, fops)):
        if x.device != device:
            raise ValueError(f"operand {name}: on {x.device}, expected {device}")

    dt = cfg.dt if dt is None else dt
    gx, gy = cfg.gravity
    if accel is not None:
        gx, gy = gx + accel[0], gy + accel[1]
    outs = [torch.empty((n, B), dtype=torch.float32, device=device) for _ in range(6)]
    active = torch.empty((C, B), dtype=torch.bool, device=device)
    geo = torch.empty((4, C, B), dtype=torch.float32, device=device)
    scratch = torch.empty(
        (lib.contact_solver_num_fields(), C, B), dtype=torch.float32, device=device
    )
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.fused_step_fwd(
        *(_ptr(x) for x in s), _ptr(tx), _ptr(ty),
        *(_ptr(x) for x in outs), _ptr(active),
        *(_ptr(x) for x in fops),
        *(_ptr(x) for x in sops),
        _ptr(geo), _ptr(scratch),
        P, len(fops.pair_i), MAX_VERTS, sum(1 << p for p in tparts),
        int(cfg.integrator == "symplectic"), float(gx * dt), float(gy * dt),
        *_tail(world, cfg.solver_iterations, cfg.position_iterations, dt, cfg.contact,
               B, C, n, stream),
    )
    if err != 0:
        raise RuntimeError(f"fused_step_fwd launch failed: CUDA error {err}")
    launches += 1
    return s._replace(
        px=outs[0], py=outs[1], vx=outs[2], vy=outs[3], angle=outs[4], omega=outs[5]
    ), _exported(active)
