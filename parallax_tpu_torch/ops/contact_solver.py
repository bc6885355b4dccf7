"""The contact solve with fused joints: CUDA kernels, wrapper, plain versions.

``csrc/contact_solver.cu`` replaces ``parallax_tpu/ops/pallas_solver.py``'s
``_solver_kernel``: one launch runs every velocity and position iteration
of ``engine.batched.solve_contacts_bm`` and then the spring-damper joints
of ``engine.batched.apply_joints_bm``.  ``csrc/contact_solver_bwd.cu``
replaces its reverse pass, ``_solver_bwd_kernel``: it recomputes the
forward from the primal inputs and returns the cotangents of the body
planes and of the contact planes.  Both run the solver walk of
``csrc/solver_walk.cuh``, one warp per world with the world's state in
shared memory, ``WORLDS_PER_BLOCK`` worlds a block (fewer where they would
not fit); so do the fused step's kernels (``ops/fused_step.py``).

:func:`solve_contacts` chooses by the tensors' device and nothing else: on
CPU tensors it runs :func:`solve_contacts_plain`, and autograd of its
plain ops is the backward; on CUDA tensors it launches the forward kernel,
and under autograd (grad enabled and an input that requires it) it does so
through :class:`_ContactSolve`, whose backward launches the reverse-pass
kernel.  A failing build or launch raises; neither kernel falls back to
the other or to a plain version.  ``launches`` and ``bwd_launches`` count
the two kernels' launches; only the launches themselves add to them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from parallax_tpu_torch.dynamics.impulses import ContactSolverConfig
from parallax_tpu_torch.engine.batched import (
    ContactsBM, _max_c, _SoA, apply_joints_bm, solve_contacts_bm,
)

# kernel launches in this process (see module docstring)
launches = 0
bwd_launches = 0

# worlds a block of each of the four kernels walks, one warp each (at most 8)
WORLDS_PER_BLOCK = 8
# dynamic shared memory a block may take on the H100: 227 KB
SMEM_LIMIT = 232448
# the solve keeps a world's lane fields in shared memory where this many
# worlds a block still fit with them, else in scratch (see solve_plan)
FIELDS_MIN_WORLDS = 4

_CON_PLANES = ("pen_x", "pen_y", "pt_x", "pt_y")


# ---------------------------------------------------------------------------
# joints: host-side table + the plain torch implementation
# ---------------------------------------------------------------------------


def joint_rows(world):
    """Host-side joint table as plain floats: ``(rows, inv_mass, inv_inertia)``.

    ``rows`` holds one dict per joint (bodies ``a``/``b``, local anchors
    ``ax, ay, bx, by``, gains ``kp, kd, v0``); the inverse masses and
    inertias are per-body float32 values (0 for static bodies)."""

    def build():
        j = world.joints
        anc_a = j.anchor_a.cpu().numpy()
        anc_b = j.anchor_b.cpu().numpy()
        kp, kd, v0 = (x.cpu().numpy() for x in (j.kp, j.kd, j.v0))
        rows = tuple(
            dict(
                a=j.body_a[k], b=j.body_b[k],
                ax=float(anc_a[k, 0]), ay=float(anc_a[k, 1]),
                bx=float(anc_b[k, 0]), by=float(anc_b[k, 1]),
                kp=float(kp[k]), kd=float(kd[k]), v0=float(v0[k]),
            )
            for k in range(j.n_joints)
        )
        im = tuple(world.params.inv_mass.cpu().numpy().tolist())
        ii = tuple(world.params.inv_inertia.cpu().numpy().tolist())
        return rows, im, ii

    return world.static(("joint_rows",), build)


def apply_joint_rows(jrows, im, ii, px, py, vx, vy, ang, om):
    """Sequential spring-damper joints on ``[n, B]`` planes, in joint order;
    each joint sees the velocities the previous one left.  Returns the new
    ``(vx, vy, om)``."""
    n = px.shape[0]
    vx_r = [vx[b] for b in range(n)]
    vy_r = [vy[b] for b in range(n)]
    om_r = [om[b] for b in range(n)]
    for j in jrows:
        a, b = j["a"], j["b"]
        ca, sa_ = torch.cos(ang[a]), torch.sin(ang[a])
        cb, sb_ = torch.cos(ang[b]), torch.sin(ang[b])
        pax = px[a] + ca * j["ax"] - sa_ * j["ay"]
        pay = py[a] + sa_ * j["ax"] + ca * j["ay"]
        pbx = px[b] + cb * j["bx"] - sb_ * j["by"]
        pby = py[b] + sb_ * j["bx"] + cb * j["by"]
        rax, ray = pax - px[a], pay - py[a]
        rbx, rby = pbx - px[b], pby - py[b]
        vax = vx_r[a] - ray * om_r[a]
        vay = vy_r[a] + rax * om_r[a]
        vbx = vx_r[b] - rby * om_r[b]
        vby = vy_r[b] + rbx * om_r[b]
        dpx, dpy = pax - pbx, pay - pby
        dvx_, dvy_ = vax - vbx, vay - vby
        dvn = torch.sqrt(_max_c(dvx_ * dvx_ + dvy_ * dvy_, 1e-30))
        Jx = dpx * j["kp"] + dvx_ * (dvn + j["v0"]) * j["kd"]
        Jy = dpy * j["kp"] + dvy_ * (dvn + j["v0"]) * j["kd"]
        vx_r[a] = vx_r[a] - Jx * im[a]
        vx_r[b] = vx_r[b] + Jx * im[b]
        vy_r[a] = vy_r[a] - Jy * im[a]
        vy_r[b] = vy_r[b] + Jy * im[b]
        om_r[a] = om_r[a] - (rax * Jy - ray * Jx) * ii[a]
        om_r[b] = om_r[b] + (rbx * Jy - rby * Jx) * ii[b]
    return torch.stack(vx_r), torch.stack(vy_r), torch.stack(om_r)


# ---------------------------------------------------------------------------
# the kernel's static operands
# ---------------------------------------------------------------------------


class SolverOperands(NamedTuple):
    """Static kernel inputs, on the world's device.

    ``is_lead`` and ``has_p`` of a lane follow from ``partner``
    (``partner >= 0``; ``partner > lane``), so the kernel derives them."""

    body_a: torch.Tensor  # [C] int32
    body_b: torch.Tensor  # [C] int32
    partner: torch.Tensor  # [C] int32, -1 where none
    lane_const: torch.Tensor  # [6, C] f32: im_a, im_b, ii_a, ii_b, e, mu
    movable: torch.Tensor  # [n] int32: 0 for static bodies
    body_im: torch.Tensor  # [n] f32 inverse masses (joints)
    body_ii: torch.Tensor  # [n] f32 inverse inertias (joints)
    joint_body: torch.Tensor  # [J, 2] int32
    joint_f: torch.Tensor  # [J, 7] f32: ax, ay, bx, by, kp, kd, v0


def solver_operands(world, config: ContactSolverConfig) -> SolverOperands:
    """The kernel's static operands, made on the host (the counterpart of
    ``_build_operands``).

    The per-lane restitution honours ``config.restitution_mode`` as
    ``solve_contacts_bm`` does, so the kernel and its plain version agree
    under either mode."""

    def build():
        table = world.table
        ia = np.asarray(table.body_a, np.int64)
        ib = np.asarray(table.body_b, np.int64)
        params = world.params
        im = params.inv_mass.cpu().numpy().astype(np.float32)
        ii = params.inv_inertia.cpu().numpy().astype(np.float32)
        el = params.elasticity.cpu().numpy()
        fr = params.friction.cpu().numpy()
        if config.restitution_mode == "min":
            e = np.minimum(el[ia], el[ib])
        else:
            e = (el[ia] + el[ib]) / np.float32(2)
        mu = (fr[ia] + fr[ib]) / np.float32(2)
        lane_const = np.stack([im[ia], im[ib], ii[ia], ii[ib], e, mu]).astype(np.float32)
        J = world.joints.n_joints
        rows, _, _ = joint_rows(world)
        joint_body = np.asarray([[r["a"], r["b"]] for r in rows], np.int32).reshape(J, 2)
        joint_f = np.asarray(
            [[r[k] for k in ("ax", "ay", "bx", "by", "kp", "kd", "v0")] for r in rows],
            np.float32,
        ).reshape(J, 7)
        movable = np.asarray([not st for st in world.static_bodies], np.int32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(world.device)

        return SolverOperands(
            body_a=t(ia.astype(np.int32)),
            body_b=t(ib.astype(np.int32)),
            partner=t(np.asarray(table.partner, np.int32)),
            lane_const=t(lane_const),
            movable=t(movable),
            body_im=t(im),
            body_ii=t(ii),
            joint_body=t(joint_body),
            joint_f=t(joint_f),
        )

    return world.static(("solver_operands", config.restitution_mode), build)


def body_lanes(world) -> torch.Tensor:
    """Per body, the lanes touching it in lane order, as the kernels' warp
    walk sums them: int32 ``[n + 1 + 2C]``, the offsets of each body's
    entries, then the entries ``2 * lane + side`` (side 0: the lane's body
    A, 1: its body B).  The kernels' per-body sums follow a serial loop's
    lane order; a 2x2 block adds its lead's terms and then its
    partner's, which is lane order only while a manifold's two lanes sit
    side by side, as ``engine/collider.py`` lays them out: anything else
    raises."""

    def build():
        table = world.table
        C, n = table.n_contacts, world.n_bodies
        partner = np.asarray(table.partner, np.int64)
        lanes = np.arange(C)
        if not np.all((partner < 0) | (np.abs(partner - lanes) == 1)):
            raise ValueError("solver kernels: a manifold's two lanes must be adjacent")
        touch = [[] for _ in range(n)]
        for c, (a, b) in enumerate(zip(table.body_a, table.body_b)):
            touch[a].append(2 * c)
            touch[b].append(2 * c + 1)
        off = np.cumsum([0] + [len(x) for x in touch])
        flat = np.concatenate([off, *map(np.asarray, touch)]).astype(np.int32)
        return torch.from_numpy(flat).to(world.device)

    return world.static(("body_lanes",), build)


def worlds_per_block(per_world: int, kernel: str) -> int:
    """The worlds a block of ``kernel`` holds: at most ``WORLDS_PER_BLOCK``,
    as many as ``SMEM_LIMIT`` leaves room for at ``per_world`` bytes of
    shared memory each.  A world over the limit alone raises
    ``ValueError``: the kernel cannot run it."""
    if per_world > SMEM_LIMIT:
        raise ValueError(
            f"{kernel}: one world needs {per_world} bytes of shared memory, over the "
            f"{SMEM_LIMIT} bytes (227 KB) a block may take on the H100"
        )
    return max(1, min(WORLDS_PER_BLOCK, SMEM_LIMIT // per_world))


def fields_plan(smem_bytes, kernel: str) -> tuple:
    """A forward kernel's launch plan, ``(fields_in_smem, worlds a block)``,
    from ``smem_bytes(fields_in_smem)``, the bytes a world takes with (1)
    and without (0) its lane fields and impulses (``NUM_FIELDS`` x C
    floats): they sit in shared memory beside the world's state where
    ``FIELDS_MIN_WORLDS`` worlds a block still fit with them, else in the
    wrapper's world-major scratch (billiards48, C=1320 lanes, and larger
    worlds)."""
    inside = smem_bytes(1)
    if SMEM_LIMIT // inside >= FIELDS_MIN_WORLDS:
        return 1, worlds_per_block(inside, kernel)
    return 0, worlds_per_block(smem_bytes(0), kernel)


def solve_plan(lib, C: int, n: int) -> tuple:
    """The solve kernel's launch plan, ``(fields_in_smem, worlds a
    block)``: :func:`fields_plan` of its shared memory."""
    return fields_plan(lambda f: lib.contact_solver_fwd_smem_bytes(C, n, f),
                       "contact_solve_fwd")


def field_scratch(lib, in_smem: int, C: int, B: int, device):
    """The forward kernels' lane-field scratch ``[B, NUM_FIELDS * C]``, or
    ``[B, 0]`` where the plan keeps the fields in shared memory."""
    rows = 0 if in_smem else lib.contact_solver_num_fields() * C
    return torch.empty((B, rows), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# plain version, wrapper, launch
# ---------------------------------------------------------------------------


def solve_contacts_plain(
    world, s, con, iterations: int, position_iterations: int, dt: float,
    config: ContactSolverConfig,
):
    """The kernel's plain torch version: ``solve_contacts_bm`` followed by
    ``apply_joints_bm``."""
    s = solve_contacts_bm(world, s, con, iterations, position_iterations, dt, config)
    return apply_joints_bm(world, s)


def solve_contacts_bwd_plain(
    world, s, con, grads, iterations: int, position_iterations: int, dt: float,
    config: ContactSolverConfig,
):
    """The reverse-pass kernel's plain version: the VJP of
    :func:`solve_contacts_plain` at ``(s, con)`` for the output cotangents
    ``grads`` (an ``_SoA``), by autograd of the plain ops.  Returns
    ``(ds, dpen_x, dpen_y, dpt_x, dpt_y)``, ``ds`` an ``_SoA``."""
    with torch.enable_grad():
        s_in = type(s)(*(x.detach().requires_grad_(True) for x in s))
        planes = {k: getattr(con, k).detach().requires_grad_(True) for k in _CON_PLANES}
        out = solve_contacts_plain(
            world, s_in, con._replace(**planes), iterations, position_iterations,
            dt, config,
        )
        inputs = (*s_in, *planes.values())
        got = torch.autograd.grad(tuple(out), inputs, tuple(grads), allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g for g, x in zip(got, inputs)]
    return (type(s)(*got[:6]), *got[6:])


def solve_contacts(
    world, s, con, iterations: int, position_iterations: int, dt: float,
    config: ContactSolverConfig,
):
    """Contact solve, then the joints: the kernel on CUDA tensors, the plain
    version on CPU tensors.  Returns the new ``_SoA`` body planes."""
    device = s.px.device
    if device.type == "cpu":
        return solve_contacts_plain(
            world, s, con, iterations, position_iterations, dt, config
        )
    if device.type != "cuda":
        raise ValueError(f"contact solver: no kernel for device {device}")
    planes = tuple(getattr(con, k) for k in _CON_PLANES)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (*s, *planes)):
        out = _ContactSolve.apply(
            (world, iterations, position_iterations, dt, config),
            *planes, con.active, *s,
        )
        return type(s)(*out)
    return _solve_cuda(world, s, con, iterations, position_iterations, dt, config)


class _ContactSolve(torch.autograd.Function):
    """The CUDA solve under autograd: the forward kernel, and the reverse-pass
    kernel as its backward.  It saves the primal inputs only (the TPU
    path's residual policy); the backward recomputes the rest.  ``active``
    takes no cotangent."""

    @staticmethod
    def forward(ctx, statics, pen_x, pen_y, pt_x, pt_y, active, *body):
        world, iterations, position_iterations, dt, config = statics
        s = _SoA(*body)
        con = ContactsBM(pen_x, pen_y, pt_x, pt_y, active, None)
        out = _solve_cuda(world, s, con, iterations, position_iterations, dt, config)
        ctx.statics = statics
        ctx.save_for_backward(pen_x, pen_y, pt_x, pt_y, active, *body)
        return tuple(out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        pen_x, pen_y, pt_x, pt_y, active, *body = ctx.saved_tensors
        s = _SoA(*body)
        con = ContactsBM(pen_x, pen_y, pt_x, pt_y, active, None)
        ds, *dcon = _solve_bwd_cuda(ctx.statics[0], s, con, _SoA(*grads), *ctx.statics[1:])
        return (None, *dcon, None, *ds)


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch_operands(world, s, con, config):
    """Check the planes, and return ``(lib, ops, C, n, B, stream)``."""
    from parallax_tpu_torch.ops import _build

    lib = _build.load()
    device = s.px.device
    C = world.table.n_contacts
    n, B = s.px.shape
    for name, x in zip(s._fields, s):
        _check(name, x, (n, B), torch.float32, device)
    for name in _CON_PLANES:
        _check(name, getattr(con, name), (C, B), torch.float32, device)
    _check("active", con.active, (C, B), torch.bool, device)
    ops = solver_operands(world, config)
    for name, x in zip(ops._fields, ops):
        if x.device != device:
            raise ValueError(f"operand {name}: on {x.device}, expected {device}")
    return lib, ops, C, n, B, torch.cuda.current_stream(device).cuda_stream


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _tail(world, iterations, position_iterations, dt, config, B, C, n, stream, *plan):
    """The scalar arguments the kernels end with; the launch ``plan`` (a
    kernel's worlds per block, and what comes before it) comes before the
    stream."""
    max_bias = config.baumgarte_max_bias
    return (
        B, C, n, world.joints.n_joints,
        iterations, position_iterations,
        float(dt), float(config.baumgarte), float(config.baumgarte_slop),
        float(config.baumgarte_dt),
        0.0 if max_bias is None else float(max_bias),
        0 if max_bias is None else 1,
        *plan,
        ctypes.c_void_p(stream),
    )


def _solve_cuda(world, s, con, iterations, position_iterations, dt, config):
    global launches
    lib, ops, C, n, B, stream = _launch_operands(world, s, con, config)
    device = s.px.device
    outs = [torch.empty((n, B), dtype=torch.float32, device=device) for _ in range(6)]
    in_smem, W = solve_plan(lib, C, n)
    scratch = field_scratch(lib, in_smem, C, B, device)
    err = lib.contact_solve_fwd(
        *(_ptr(getattr(con, k)) for k in (*_CON_PLANES, "active")),
        *(_ptr(x) for x in s),
        *(_ptr(x) for x in outs),
        *(_ptr(x) for x in ops),
        _ptr(body_lanes(world)),
        _ptr(scratch),
        *_tail(world, iterations, position_iterations, dt, config, B, C, n, stream,
               in_smem, W),
    )
    if err != 0:
        raise RuntimeError(f"contact_solve_fwd launch failed: CUDA error {err}")
    launches += 1
    return s._replace(
        px=outs[0], py=outs[1], vx=outs[2], vy=outs[3], angle=outs[4], omega=outs[5]
    )


def solve_contacts_bwd(world, s, con, grads, iterations, position_iterations, dt, config):
    """The reverse-pass kernel on CUDA tensors, the plain version on CPU
    tensors: the VJP of :func:`solve_contacts` at ``(s, con)`` for the
    output cotangents ``grads``.  Returns ``(ds, dpen_x, dpen_y, dpt_x,
    dpt_y)``."""
    device = s.px.device
    if device.type == "cpu":
        return solve_contacts_bwd_plain(
            world, s, con, grads, iterations, position_iterations, dt, config
        )
    if device.type != "cuda":
        raise ValueError(f"contact solver: no kernel for device {device}")
    return _solve_bwd_cuda(world, s, con, grads, iterations, position_iterations, dt, config)


def _solve_bwd_cuda(world, s, con, grads, iterations, position_iterations, dt, config):
    global bwd_launches
    lib, ops, C, n, B, stream = _launch_operands(world, s, con, config)
    device = s.px.device
    grads = [g.contiguous() for g in grads]
    for name, g in zip(s._fields, grads):
        _check(f"cotangent {name}", g, (n, B), torch.float32, device)
    ds = [torch.empty((n, B), dtype=torch.float32, device=device) for _ in range(6)]
    dcon = [torch.empty((C, B), dtype=torch.float32, device=device) for _ in range(4)]
    rows = lib.contact_solver_bwd_scratch_rows(C, n, iterations, position_iterations)
    scratch = torch.empty((B, rows), dtype=torch.float32, device=device)
    W = worlds_per_block(lib.contact_solver_bwd_smem_bytes(C, n), "contact_solve_bwd")
    err = lib.contact_solve_bwd(
        *(_ptr(getattr(con, k)) for k in (*_CON_PLANES, "active")),
        *(_ptr(x) for x in s),
        *(_ptr(g) for g in grads),
        *(_ptr(x) for x in ds),
        *(_ptr(x) for x in dcon),
        *(_ptr(x) for x in ops),
        _ptr(body_lanes(world)),
        _ptr(scratch),
        *_tail(world, iterations, position_iterations, dt, config, B, C, n, stream, W),
    )
    if err != 0:
        raise RuntimeError(f"contact_solve_bwd launch failed: CUDA error {err}")
    bwd_launches += 1
    return (type(s)(*ds), *dcon)
