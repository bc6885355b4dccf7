"""The fused physics step: CUDA kernels, wrapper and plain versions.

``csrc/fused_step.cu`` replaces ``parallax_tpu/ops/pallas_step.py``'s
``_step_kernel`` for worlds whose pair groups are polygon-polygon (``pp``),
circle-circle (``cc``), circle-box (``cb``) and circle-in-area-box
(``area_cb``): one launch runs integration and gravity, the world-frame
vertices (with the per-world terrain override), each pair's contact lanes
(the SAT manifold of a ``pp`` pair, the analytic lane of a ``cc``, ``cb``
or ``area_cb`` pair), the contact solve and the joints, one CUDA thread per
world.  The contact geometry stays inside the kernel; it returns the body
planes and the ``[C, B]`` active flags.  Its plain version,
:func:`fused_step_plain`, is the split step of ``engine.batched`` with the
plain solver.  ``csrc/fused_step_bwd.cu`` replaces its reverse pass,
``_step_bwd_kernel``, for the same four kinds: it recomputes the step from
the primal inputs and returns the cotangents of the body planes and of the
terrain planes; its plain version, :func:`fused_step_bwd_plain`, is
autograd of :func:`fused_step_plain`.  The JAX kernels' box-box (``bb``)
lanes are not ported yet (ROADMAP Queue 1 item 8f): on CUDA tensors such a
world raises.

:func:`physics_core_fused` chooses by the tensors' device and nothing
else: on CPU tensors it runs the plain version, and autograd of its plain
ops is the backward; on CUDA tensors it checks the world and the planes
and launches the forward kernel, and under autograd (grad enabled and an
input that requires it) it does so through :class:`_FusedStep`, whose
backward launches the reverse-pass kernel.  A world the kernels do not
run, a failing build or a failing launch raises: there is no silent split
path.  ``launches`` and ``bwd_launches`` count the two kernels' launches;
only the launches themselves add to them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from parallax_tpu_torch.geometry.shapes import BOX, MAX_VERTS, edge_mask_for

# kernel launches in this process (see module docstring)
launches = 0
bwd_launches = 0

# pair-group kernels the fused kernel and its reverse pass run; the JAX
# kernel's bb lanes are not ported yet (ROADMAP Queue 1 item 8f)
FUSED_KERNELS = ("pp", "cc", "cb", "area_cb")
# the kernels' per-thread limits (csrc/fused_step.cuh, contact_solver.cuh);
# the launch refuses more as well
MAX_PARTS = 16
MAX_BODIES = 64
# kinds of pair_i's Q_KIND column, in the order of csrc/fused_step.cuh's
# PairKind
_KINDS = {"pp": 0, "cc": 1, "cb": 2, "area_cb": 3}


def supports_fused_step(world) -> bool:
    """Whether the fused kernel's pair groups cover ``world``: its groups
    are all in ``FUSED_KERNELS``, the solver is the block solver, and a
    world with a ``pp`` group has the broadphase off (the kernel has no
    AABB pre-mask; circle and box lanes mask themselves, so a world without
    a ``pp`` group may keep it on: the rule of ``pallas_step.py:84-92``).
    The kernels' size limits are :func:`check_fused_step`'s."""
    kernels = {g.kernel for g in world.table.groups}
    if not kernels <= set(FUSED_KERNELS):
        return False
    if world.config.solver_mode != "block":
        return False
    return "pp" not in kernels or not world.config.broadphase


def check_fused_step(world) -> None:
    """Raise, saying why, unless the fused kernels run ``world`` on the card.

    Beyond :func:`supports_fused_step`, a world may have at most
    ``MAX_PARTS`` = 16 parts and ``MAX_BODIES`` = 64 bodies: the kernel
    keeps every part's vertices in per-thread arrays.  So billiards with 47
    object balls (52 parts) raises here, where the JAX package silently
    takes its split step (``engine/batched.py:1158-1167``).  The reverse
    pass walks back every kind of ``FUSED_KERNELS``, so the same gate
    serves under autograd."""
    from parallax_tpu_torch.engine.batched import check_batched_support

    check_batched_support(world.config, "the fused step")
    kernels = _check_kinds(world)
    if "pp" in kernels and world.config.broadphase:
        raise ValueError(
            "the fused step kernel has no AABB pre-mask stage: build a world "
            "with polygon pairs with broadphase=False"
        )
    P = len(world.parts.nverts)
    if P > MAX_PARTS:
        raise ValueError(
            f"the fused step kernel takes at most {MAX_PARTS} parts; this "
            f"world has {P}: run it on the split step (use_cuda_fused=False)"
        )
    if world.n_bodies > MAX_BODIES:
        raise ValueError(
            f"the fused step kernel takes at most {MAX_BODIES} bodies; this "
            f"world has {world.n_bodies}"
        )


def _check_kinds(world) -> set:
    """The world's pair-group kernels; raise unless the fused kernel has
    lanes for each of them."""
    kernels = {g.kernel for g in world.table.groups}
    unported = sorted(kernels - set(FUSED_KERNELS))
    if unported:
        raise NotImplementedError(
            f"the fused step kernel runs {FUSED_KERNELS} pair groups; "
            f"{unported} are not ported yet (ROADMAP Queue 1 item 8f)"
        )
    return kernels


class FusedOperands(NamedTuple):
    """Static kernel inputs of the step's geometry, on the world's device
    (the counterpart of ``_static_step_info``).  The terrain override is a
    per-call argument: the kernel reads the k-th overridden part, in
    ``sorted(override)`` order as at ``pallas_step.py:158``, from rows
    ``k * MAX_VERTS ...`` of the terrain planes."""

    part_i: torch.Tensor  # [P, 3] int32: owning body, rotates, vertices read
    part_lv: torch.Tensor  # [P, MAX_VERTS, 2] f32 local vertices
    # [pairs, 8] int32: parts a, b, Va, Vb, edge-mask bits of a and b, first
    # lane, kind (_KINDS)
    pair_i: torch.Tensor
    # [pairs, 2] f32: radii of parts a and b (an area_cb pair: the contained
    # circle's, and 0 for the area box)
    pair_f: torch.Tensor


def fused_operands(world) -> FusedOperands:
    """Built once per world: each part's body, rotate flag and the number of
    vertex rows its groups read (their trimmed ``Va``/``Vb``: a circle's
    centre and a box's ``lb``/``ub`` for the one-lane kinds, as at
    ``pallas_step.py:108-113``), and per pair of the table, in lane order,
    its parts, trimmed row counts, edge masks (``engine.batched._group_masks``)
    as bits, its first lane (groups concatenate in ``world.table.groups``
    order: two lanes a ``pp`` pair, one a ``cc``, ``cb`` or ``area_cb``
    pair), its kind and its two radii.  A world with a group the kernel has no lanes for
    raises, so the operands never carry a kind the kernel would misread."""

    def build():
        _check_kinds(world)
        parts = world.parts
        P = len(parts.nverts)
        radius = parts.radius.cpu().numpy()
        nv = np.zeros(P, np.int32)
        pairs, radii, lane = [], [], 0
        for g in world.table.groups:
            Va = max(parts.nverts[i] for i in g.part_a)
            Vb = max(parts.nverts[i] for i in g.part_b)
            if g.kernel != "pp":
                Va, Vb = min(Va, 2), min(Vb, 2)
            for a, b in zip(g.part_a, g.part_b):
                nv[a] = max(nv[a], Va)
                nv[b] = max(nv[b], Vb)
                ma = edge_mask_for(parts.nverts[a], Va)
                mb = edge_mask_for(parts.nverts[b], Vb)
                pairs.append([a, b, Va, Vb, _bits(ma), _bits(mb), lane,
                              _KINDS[g.kernel]])
                radii.append([radius[a], radius[b]])
                lane += _width(g.kernel)
        rotate = [int(k != BOX) for k in parts.kind]
        part_i = np.stack([np.asarray(parts.body), rotate, nv], axis=1).astype(np.int32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(world.device)

        return FusedOperands(
            part_i=t(part_i),
            part_lv=parts.verts.to(torch.float32).contiguous().to(world.device),
            pair_i=t(np.asarray(pairs, np.int32).reshape(-1, 8)),
            pair_f=t(np.asarray(radii, np.float32).reshape(-1, 2)),
        )

    return world.static(("fused_operands",), build)


def _bits(mask) -> int:
    return int(sum(1 << v for v, on in enumerate(mask) if on))


def _width(kernel: str) -> int:
    """Lanes a pair of ``kernel`` writes: two for the SAT manifold, else one."""
    return 2 if kernel == "pp" else 1


def _lane_count(world) -> int:
    """The lanes the world's pair kinds give, which the launches check
    against the contact table's ``C``."""
    return sum(g.size * _width(g.kernel) for g in world.table.groups)


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


def fused_step_bwd_plain(world, s, terrain_override, grads, dt=None, accel=None):
    """The reverse-pass kernel's plain version: the VJP of
    :func:`fused_step_plain` at ``(s, terrain_override)`` for the cotangents
    ``grads`` (an ``_SoA``) of its six output body planes, by autograd of
    the plain ops.  Returns ``(ds, dtx, dty)``: ``ds`` an ``_SoA``, and the
    terrain planes' cotangents stacked as the kernel takes the planes,
    ``[k * MAX_VERTS, B]`` in ``sorted(terrain_override)`` order (no rows
    without an override)."""
    override = terrain_override or {}
    tparts = tuple(sorted(override))
    with torch.enable_grad():
        s_in = type(s)(*(x.detach().requires_grad_(True) for x in s))
        tx, ty = (x.detach().requires_grad_(True)
                  for x in _terrain_planes(override, tparts, s.px))
        out, _ = fused_step_plain(world, s_in, _split(tparts, tx, ty), dt, accel)
        inputs = (*s_in, tx, ty)
        got = torch.autograd.grad(tuple(out), inputs, tuple(grads), allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g for g, x in zip(got, inputs)]
    return type(s)(*got[:6]), got[6], got[7]


def _terrain_planes(override, tparts, like):
    """The override parts' x and y planes, concatenated in ``tparts`` order
    into the kernel's ``[k * MAX_VERTS, B]`` layout (no rows when empty)."""
    if not tparts:
        empty = like.new_empty((0, like.shape[-1]))
        return empty, empty
    return (torch.cat([override[p][0] for p in tparts]),
            torch.cat([override[p][1] for p in tparts]))


def _split(tparts, tx, ty):
    """The inverse of :func:`_terrain_planes`: ``{part: (x, y)}`` views."""
    V = MAX_VERTS
    return {p: (tx[k * V:(k + 1) * V], ty[k * V:(k + 1) * V]) for k, p in enumerate(tparts)}


def physics_core_fused(world, s, terrain_override=None, dt=None, accel=None):
    """The fused step: the kernel on CUDA tensors, the plain version on CPU
    tensors.  ``terrain_override`` is ``{part: ([MAX_VERTS, B] x, y)}`` of
    world-frame vertex planes.  Returns ``(_SoA, ContactsBM)``."""
    from parallax_tpu_torch.ops.contact_solver import _check

    device = s.px.device
    if device.type == "cpu":
        return fused_step_plain(world, s, terrain_override, dt, accel)
    if device.type != "cuda":
        raise ValueError(f"fused step: no kernel for device {device}")
    override = terrain_override or {}
    tparts = tuple(sorted(override))
    for p in tparts:
        for name, x in zip(("x", "y"), override[p]):
            _check(f"terrain_override[{p}] {name}", x, (MAX_VERTS, s.px.shape[-1]),
                   torch.float32, device)
    tx, ty = _terrain_planes(override, tparts, s.px)
    statics = (world, tparts, dt, accel)
    check_fused_step(world)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (*s, tx, ty)):
        *out, active = _FusedStep.apply(statics, tx, ty, *s)
        return type(s)(*out), _exported(active)
    out, active = _step_cuda(statics, s, tx, ty)
    return out, _exported(active)


class _FusedStep(torch.autograd.Function):
    """The fused step on CUDA tensors under autograd: the forward kernel, and
    the reverse-pass kernel as its backward.  It saves the primal inputs
    only (the TPU path's residual policy); the backward recomputes the
    rest.  The terrain planes enter concatenated, so ``torch.cat``'s
    backward routes their cotangents to each part.  ``active`` takes no
    cotangent."""

    @staticmethod
    def forward(ctx, statics, tx, ty, *body):
        from parallax_tpu_torch.engine.batched import _SoA

        out, active = _step_cuda(statics, _SoA(*body), tx, ty)
        ctx.statics = statics
        ctx.save_for_backward(tx, ty, *body)
        ctx.mark_non_differentiable(active)
        return (*out, active)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        from parallax_tpu_torch.engine.batched import _SoA

        tx, ty, *body = ctx.saved_tensors
        ds, dtx, dty = _fused_bwd_cuda(ctx.statics, _SoA(*body), tx, ty, _SoA(*grads[:6]))
        return (None, dtx, dty, *ds)


def _launch_operands(statics, s, tx, ty):
    """Check the planes and the world; return the library, the pointers of
    the kernels' static operands, the scalar arguments both kernels end
    with, and the shapes."""
    from parallax_tpu_torch.ops import _build
    from parallax_tpu_torch.ops.contact_solver import _check, _ptr, _tail, solver_operands

    world, tparts, dt, accel = statics
    lib = _build.load()
    cfg = world.config
    device = s.px.device
    C = world.table.n_contacts
    n, B = s.px.shape
    P = len(world.parts.nverts)  # check_fused_step holds it to MAX_PARTS
    for name, x in zip(s._fields, s):
        _check(name, x, (n, B), torch.float32, device)
    for name, x in (("terrain x", tx), ("terrain y", ty)):
        _check(name, x, (len(tparts) * MAX_VERTS, B), torch.float32, device)
    sops = solver_operands(world, cfg.contact)
    fops = fused_operands(world)
    for name, x in (*zip(sops._fields, sops), *zip(fops._fields, fops)):
        if x.device != device:
            raise ValueError(f"operand {name}: on {x.device}, expected {device}")

    dt = cfg.dt if dt is None else dt
    gx, gy = cfg.gravity
    if accel is not None:
        gx, gy = gx + accel[0], gy + accel[1]
    stream = torch.cuda.current_stream(device).cuda_stream
    scalars = (
        P, len(fops.pair_i), _lane_count(world), MAX_VERTS, sum(1 << p for p in tparts),
        int(cfg.integrator == "symplectic"), float(gx * dt), float(gy * dt),
        *_tail(world, cfg.solver_iterations, cfg.position_iterations, dt, cfg.contact,
               B, C, n, stream),
    )
    operands = (*(_ptr(x) for x in fops), *(_ptr(x) for x in sops))
    return lib, operands, scalars, (C, n, B)


def _step_cuda(statics, s, tx, ty):
    global launches
    from parallax_tpu_torch.ops.contact_solver import _ptr

    lib, operands, scalars, (C, n, B) = _launch_operands(statics, s, tx, ty)
    device = s.px.device
    outs = [torch.empty((n, B), dtype=torch.float32, device=device) for _ in range(6)]
    active = torch.empty((C, B), dtype=torch.bool, device=device)
    geo = torch.empty((4, C, B), dtype=torch.float32, device=device)
    scratch = torch.empty(
        (lib.contact_solver_num_fields(), C, B), dtype=torch.float32, device=device
    )
    err = lib.fused_step_fwd(
        *(_ptr(x) for x in s), _ptr(tx), _ptr(ty),
        *(_ptr(x) for x in outs), _ptr(active),
        *operands, _ptr(geo), _ptr(scratch), *scalars,
    )
    if err != 0:
        raise RuntimeError(f"fused_step_fwd launch failed: CUDA error {err}")
    launches += 1
    return type(s)(*outs), active


def fused_step_bwd(world, s, terrain_override, grads, dt=None, accel=None):
    """The reverse-pass kernel on CUDA tensors, the plain version on CPU
    tensors: the VJP of :func:`physics_core_fused`'s body planes at ``(s,
    terrain_override)`` for their cotangents ``grads``.  Returns ``(ds,
    dtx, dty)`` as :func:`fused_step_bwd_plain` does."""
    device = s.px.device
    if device.type == "cpu":
        return fused_step_bwd_plain(world, s, terrain_override, grads, dt, accel)
    if device.type != "cuda":
        raise ValueError(f"fused step: no kernel for device {device}")
    check_fused_step(world)
    override = terrain_override or {}
    tparts = tuple(sorted(override))
    tx, ty = _terrain_planes(override, tparts, s.px)
    return _fused_bwd_cuda((world, tparts, dt, accel), s, tx, ty, grads)


def _fused_bwd_cuda(statics, s, tx, ty, grads):
    global bwd_launches
    from parallax_tpu_torch.ops.contact_solver import _check, _ptr

    lib, operands, scalars, (C, n, B) = _launch_operands(statics, s, tx, ty)
    device = s.px.device
    grads = [g.contiguous() for g in grads]
    for name, g in zip(s._fields, grads):
        _check(f"cotangent {name}", g, (n, B), torch.float32, device)
    ds = [torch.empty((n, B), dtype=torch.float32, device=device) for _ in range(6)]
    dtx, dty = torch.empty_like(tx), torch.empty_like(ty)
    cfg = statics[0].config
    rows = lib.fused_step_bwd_scratch_rows(C, n, cfg.solver_iterations, cfg.position_iterations)
    scratch = torch.empty((rows, B), dtype=torch.float32, device=device)
    err = lib.fused_step_bwd(
        *(_ptr(x) for x in s), _ptr(tx), _ptr(ty),
        *(_ptr(g) for g in grads),
        *(_ptr(x) for x in ds), _ptr(dtx), _ptr(dty),
        *operands, _ptr(scratch), *scalars,
    )
    if err != 0:
        raise RuntimeError(f"fused_step_bwd launch failed: CUDA error {err}")
    bwd_launches += 1
    return type(s)(*ds), dtx, dty
