"""The fused physics step: CUDA kernels, wrapper and plain versions.

``csrc/fused_step.cu`` replaces ``parallax_tpu/ops/pallas_step.py``'s
``_step_kernel`` for worlds whose pair groups are the JAX kernel's five
kinds: polygon-polygon (``pp``), circle-circle (``cc``), circle-box
(``cb``), box-box (``bb``) and circle-in-area-box (``area_cb``).  One launch
runs integration and gravity, the world-frame vertices (with the per-world
terrain override), each pair's contact lanes (the SAT manifold of a ``pp``
pair, the analytic lane of the others), the contact solve and the joints,
one warp per world with the world's state in shared memory.  The contact
geometry stays inside the kernel; it returns the body planes and the
``[C, B]`` active flags.  Its plain
version, :func:`fused_step_plain`, is the split step of ``engine.batched``
with the plain solver.  ``csrc/fused_step_bwd.cu`` replaces its reverse
pass, ``_step_bwd_kernel``, for the same five kinds: it recomputes the step
from the primal inputs and returns the cotangents of the body planes and
of the terrain planes, one warp per world with the world's state in shared
memory; its plain version,
:func:`fused_step_bwd_plain`, is autograd of :func:`fused_step_plain`.  A world with a kind neither the JAX
fused kernel nor these have (``cp``, ``bp`` and the area kinds other than
``area_cb``) raises: it runs on the split step.

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

from parallax_tpu_torch.geometry.shapes import BOX, MAX_VERTS

# kernel launches in this process (see module docstring)
launches = 0
bwd_launches = 0

# pair-group kernels the fused kernel and its reverse pass run: those of
# the JAX fused kernel (pallas_step.py:81)
FUSED_KERNELS = ("pp", "cc", "cb", "bb", "area_cb")
# kinds of pair_i's Q_KIND column, in the order of csrc/fused_step.cuh's
# PairKind
_KINDS = {"pp": 0, "cc": 1, "cb": 2, "area_cb": 3, "bb": 4}


def supports_fused_step(world) -> bool:
    """Whether the fused kernel's pair groups cover ``world``: its groups
    are all in ``FUSED_KERNELS``, the solver is the block solver, and a
    world with a ``pp`` group has the broadphase off (the kernel has no
    AABB pre-mask; circle and box lanes mask themselves, so a world without
    a ``pp`` group may keep it on: the rule of ``pallas_step.py:84-92``).
    The kernels take a world of any size whose launch plan fits a block's
    shared memory (``contact_solver.worlds_per_block``)."""
    kernels = {g.kernel for g in world.table.groups}
    if not kernels <= set(FUSED_KERNELS):
        return False
    if world.config.solver_mode != "block":
        return False
    return "pp" not in kernels or not world.config.broadphase


def check_fused_step(world) -> None:
    """Raise, saying why, unless the fused kernels run ``world`` on the card:
    the rule of :func:`supports_fused_step`, as the JAX gate
    (``pallas_step.py:84-92``) has it, with no limit on parts or bodies.
    The reverse pass walks back every kind of ``FUSED_KERNELS``, so the
    same gate serves under autograd.  A world too large for one block's
    shared memory raises at its launch plan
    (``contact_solver.worlds_per_block``)."""
    from parallax_tpu_torch.engine.batched import check_batched_support

    check_batched_support(world.config, "the fused step")
    kernels = _check_kinds(world)
    if "pp" in kernels and world.config.broadphase:
        raise ValueError(
            "the fused step kernel has no AABB pre-mask stage: build a world "
            "with polygon pairs with broadphase=False"
        )


def _check_kinds(world) -> set:
    """The world's pair-group kernels; raise unless the fused kernel has
    lanes for each of them.  The kinds it lacks the JAX fused kernel lacks
    too: there such a world takes the split step without a word
    (``engine/batched.py:1159-1167``); here it raises."""
    kernels = {g.kernel for g in world.table.groups}
    other = sorted(kernels - set(FUSED_KERNELS))
    if other:
        raise ValueError(
            f"the fused step runs {FUSED_KERNELS} pair groups, as the JAX "
            f"package's fused kernel does; this world has {other}: run it on "
            "the split step (use_cuda_fused=False)"
        )
    return kernels


class FusedOperands(NamedTuple):
    """Static kernel inputs of the step's geometry, on the world's device
    (the counterpart of ``_static_step_info``), for one set of overridden
    parts: the kernel reads the k-th overridden part, in ``sorted(override)``
    order as at ``pallas_step.py:158``, from rows ``k * MAX_VERTS ...`` of
    the terrain planes; ``part_i``'s last column holds that k, or -1."""

    # [P, 4] int32: owning body, rotates, vertices read, override rank
    part_i: torch.Tensor
    part_lv: torch.Tensor  # [P, MAX_VERTS, 2] f32 local vertices
    # [pairs, 8] int32: parts a, b, Va, Vb, edge-mask bits of a and b, first
    # lane, kind (_KINDS)
    pair_i: torch.Tensor
    # [pairs, 2] f32: radii of parts a and b (an area_cb pair: the contained
    # circle's, and 0 for the area box)
    pair_f: torch.Tensor


def fused_operands(world, tparts=()) -> FusedOperands:
    """Built once per world and set of overridden parts ``tparts`` (sorted):
    each part's body, rotate flag, the number of vertex rows its groups read
    and its rank in ``tparts`` (-1 where it is not overridden), and per pair
    of the table, in lane order,
    its parts, the rows and edge masks (as bits) of the split collide's
    ``engine.batched._group_rows`` (a circle's centre and a box's ``lb``/
    ``ub`` for the one-lane kinds, as at ``pallas_step.py:108-113``), its
    first lane (groups concatenate in ``world.table.groups`` order: two
    lanes a ``pp`` pair, one a pair of any other kind), its kind and its two
    radii.  A world with a group the kernel has no lanes for raises, so the
    operands never carry a kind the kernel would misread."""
    from parallax_tpu_torch.engine.batched import _group_rows

    def build():
        _check_kinds(world)
        parts = world.parts
        P = len(parts.nverts)
        radius = parts.radius.cpu().numpy()
        nv = np.zeros(P, np.int32)
        pairs, radii, lane = [], [], 0
        for g in world.table.groups:
            Va, Vb, ema, emb = _group_rows(world, g)
            for a, b, ma, mb in zip(g.part_a, g.part_b, ema.tolist(), emb.tolist()):
                nv[a] = max(nv[a], Va)
                nv[b] = max(nv[b], Vb)
                pairs.append([a, b, Va, Vb, _bits(ma), _bits(mb), lane,
                              _KINDS[g.kernel]])
                radii.append([radius[a], radius[b]])
                lane += _width(g.kernel)
        rotate = [int(k != BOX) for k in parts.kind]
        rank = np.full(P, -1, np.int32)
        rank[list(tparts)] = np.arange(len(tparts))
        part_i = np.stack([np.asarray(parts.body), rotate, nv, rank],
                          axis=1).astype(np.int32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(world.device)

        return FusedOperands(
            part_i=t(part_i),
            part_lv=parts.verts.to(torch.float32).contiguous().to(world.device),
            pair_i=t(np.asarray(pairs, np.int32).reshape(-1, 8)),
            pair_f=t(np.asarray(radii, np.float32).reshape(-1, 2)),
        )

    return world.static(("fused_operands", tuple(tparts)), build)


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
        _check_kinds(world)
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


def _launch_operands(statics, s, tx, ty, plan):
    """Check the planes and the world; return the library, the pointers of
    the kernels' static operands, the scalar arguments the kernels end
    with, the shapes and the launch plan.  ``plan(lib, world, C, n, P,
    pairs)`` gives the kernel's launch plan, which goes before the
    stream."""
    from parallax_tpu_torch.ops import _build
    from parallax_tpu_torch.ops.contact_solver import _check, _ptr, _tail, solver_operands

    world, tparts, dt, accel = statics
    lib = _build.load()
    cfg = world.config
    device = s.px.device
    C = world.table.n_contacts
    n, B = s.px.shape
    P = len(world.parts.nverts)
    for name, x in zip(s._fields, s):
        _check(name, x, (n, B), torch.float32, device)
    for name, x in (("terrain x", tx), ("terrain y", ty)):
        _check(name, x, (len(tparts) * MAX_VERTS, B), torch.float32, device)
    sops = solver_operands(world, cfg.contact)
    fops = fused_operands(world, tparts)
    for name, x in (*zip(sops._fields, sops), *zip(fops._fields, fops)):
        if x.device != device:
            raise ValueError(f"operand {name}: on {x.device}, expected {device}")

    dt = cfg.dt if dt is None else dt
    gx, gy = cfg.gravity
    if accel is not None:
        gx, gy = gx + accel[0], gy + accel[1]
    stream = torch.cuda.current_stream(device).cuda_stream
    pairs = len(fops.pair_i)
    launch_plan = plan(lib, world, C, n, P, pairs)
    scalars = (
        P, pairs, _lane_count(world), MAX_VERTS,
        int(cfg.integrator == "symplectic"), float(gx * dt), float(gy * dt),
        *_tail(world, cfg.solver_iterations, cfg.position_iterations, dt, cfg.contact,
               B, C, n, stream, *launch_plan),
    )
    operands = (*(_ptr(x) for x in fops), *(_ptr(x) for x in sops))
    return lib, operands, scalars, (C, n, B), launch_plan


def _step_cuda(statics, s, tx, ty):
    global launches
    from parallax_tpu_torch.ops.contact_solver import _ptr, body_lanes, field_scratch

    lib, operands, scalars, (C, n, B), (in_smem, _) = _launch_operands(
        statics, s, tx, ty, _fwd_plan)
    device = s.px.device
    outs = [torch.empty((n, B), dtype=torch.float32, device=device) for _ in range(6)]
    active = torch.empty((C, B), dtype=torch.bool, device=device)
    scratch = field_scratch(lib, in_smem, C, B, device)
    err = lib.fused_step_fwd(
        *(_ptr(x) for x in s), _ptr(tx), _ptr(ty),
        *(_ptr(x) for x in outs), _ptr(active),
        *operands, _ptr(body_lanes(statics[0])), _ptr(scratch), *scalars,
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


def _pair_rows(world) -> int:
    """The most vertex rows a pair reads of one of its parts (the rows of
    the reverse pass's per-pair slots in shared memory): 2 for the crate
    pile's circle and box pairs, up to ``MAX_VERTS`` for polygons."""
    from parallax_tpu_torch.engine.batched import _group_rows

    def build():
        return max([1] + [max(_group_rows(world, g)[:2]) for g in world.table.groups])

    return world.static(("pair_rows",), build)


def _fwd_plan(lib, world, C, n, P, pairs):
    """The forward kernel's launch plan, ``(fields_in_smem, worlds a
    block)``: the solve kernel's rule (``contact_solver.fields_plan``) for
    where its lane fields go."""
    from parallax_tpu_torch.ops.contact_solver import fields_plan

    return fields_plan(lambda f: lib.fused_step_fwd_smem_bytes(C, n, P, f), "fused_step_fwd")


def _bwd_plan(lib, world, C, n, P, pairs):
    """The reverse pass's launch plan: its per-pair slot rows and its
    worlds per block (``contact_solver.worlds_per_block``)."""
    from parallax_tpu_torch.ops.contact_solver import worlds_per_block

    R = _pair_rows(world)
    per_world = lib.fused_step_bwd_smem_bytes(C, n, P, pairs, R)
    return R, worlds_per_block(per_world, "fused_step_bwd")


def _fused_bwd_cuda(statics, s, tx, ty, grads):
    global bwd_launches
    from parallax_tpu_torch.ops.contact_solver import _check, _ptr, body_lanes

    lib, operands, scalars, (C, n, B), _ = _launch_operands(statics, s, tx, ty, _bwd_plan)
    device = s.px.device
    grads = [g.contiguous() for g in grads]
    for name, g in zip(s._fields, grads):
        _check(f"cotangent {name}", g, (n, B), torch.float32, device)
    ds = [torch.empty((n, B), dtype=torch.float32, device=device) for _ in range(6)]
    dtx, dty = torch.empty_like(tx), torch.empty_like(ty)
    cfg = statics[0].config
    rows = lib.fused_step_bwd_scratch_rows(C, n, cfg.solver_iterations, cfg.position_iterations)
    scratch = torch.empty((B, rows), dtype=torch.float32, device=device)
    err = lib.fused_step_bwd(
        *(_ptr(x) for x in s), _ptr(tx), _ptr(ty),
        *(_ptr(g) for g in grads),
        *(_ptr(x) for x in ds), _ptr(dtx), _ptr(dty),
        *operands, _ptr(body_lanes(statics[0])), _ptr(scratch), *scalars,
    )
    if err != 0:
        raise RuntimeError(f"fused_step_bwd launch failed: CUDA error {err}")
    bwd_launches += 1
    return type(s)(*ds), dtx, dty
