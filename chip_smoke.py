#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc.
It builds the port's kernels from the checkout's sources, holds each
kernel against its plain torch version on the card, drives the two paths
of the port through their entry points and checks that each path
launched its kernels, that its outputs are finite and that a small run on
the card agrees with the same run on the CPU:

* the rollout: ``LunarLander()`` (the card), ``reset_fn_batch`` +
  ``rollout_batch`` at B=8192; it runs the contact-solve kernel;
* the fused rollout: ``LunarLander(LanderConfig(broadphase=False,
  use_cuda_fused=True))``, the same entry points at B=8192; it runs the
  fused-step kernel and no other;
* the train step: ``parallel.rollout.make_train_step`` at B=8192, horizon
  100, 4 checkpoint segments, the 9-32-2 tanh policy and Adam at lr 3e-3
  (the configuration of ``bench.py --train``); it runs the contact-solve
  kernel in the forward and in each segment's recompute, and its reverse
  pass in the backward;
* the fused train step: the same over the fused world; it runs the fused
  step's kernel in the forward and the recompute, and its reverse pass in
  the backward, and neither solver kernel;
* the circle worlds at B=8192: ``Bouncer()`` and ``Billiards()`` rollouts on
  the split step (the contact-solve kernel), ``BilliardsConfig(n_object=47)``
  on the split step with its peak memory, and
  ``BilliardsConfig(use_cuda_fused=True)`` on the fused step (its circle-circle
  and circle-box lanes, and no solver launch);
* RoboCup at B=8192, ``RoboCup()`` and ``RoboCupConfig(use_cuda_fused=True)``:
  rollouts of 100 steps (the solve kernel, or the fused kernel with its
  circle-in-area lanes) and ``make_train_step`` as for the lander, with the
  28-32-18 policy (the solve kernel and its reverse pass, or the fused
  kernel and its reverse pass, whose cc, cb and area_cb lanes it walks
  back); and the fused reverse pass on billiards8 under a state objective
  (``cue_loss_fn``: billiards' own reward has no gradient path).

It prints the card's name and power limit, the timings, one JSON line of
per-kernel results and, last, one JSON line ``{"ok": true, "device":
...}``.  Any failed phase raises and the script exits non-zero; without a
CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

B = 8192
STEPS = 100
ATOL = 1e-5  # kernel vs plain version: the JAX tests' bar, float32 rounding
RTOL = 2e-4  # reverse pass vs plain VJP: the JAX package's bar for its backward
PEN_ULPS = 8  # the solver reverse pass's penetration cotangents on RoboCup (robocup_kernels)
SMALL_B, SMALL_STEPS = 1024, 60
CPU_ATOL = 1e-3  # card vs CPU rollout after 60 steps (rounding grows with steps)
CPU_DONE_SHARE = 0.99
HORIZON, SEGMENTS = 100, 4
CIRCLE_STEPS = 50  # the circle worlds' rollouts at B
SMALL_H = 12
PROFILE_H = 4  # the profiled train step: short, so its trace stays small
# card vs CPU train step: the loss is a mean of 12 rewards that agree to
# float32 rounding; the gradients pass through 12 contact steps and their
# backward, where the 2x2 block solves amplify rounding differences (the
# bar of tests/test_torch_train.py between the port and JAX on the CPU)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
HBM_BPS, F32_FLOPS = 3.35e12, 67e12


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0 and out.stdout.strip(), f"nvidia-smi: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


def keys_for(batch, seed, device):
    k = np.random.default_rng(seed).integers(0, 2**32, (batch, 2), dtype=np.uint32)
    return torch.from_numpy(k.astype(np.int64)).to(device)


def policy_params(device):
    rng = np.random.default_rng(11)
    W = (rng.standard_normal((9, 2)) * 0.5).astype(np.float32)
    b = (rng.standard_normal(2) * 0.3).astype(np.float32)
    return torch.from_numpy(W).to(device), torch.from_numpy(b).to(device)


def policy(params, obs):
    return torch.tanh(obs @ params[0] + params[1])


def mlp_params(device, width=9, out=2):
    """The train policy's weights (``bench.py:216-225``): obs ``width`` -> 32
    tanh -> ``out`` tanh (numpy, seeded); the lander's is 9-32-2."""
    rng = np.random.default_rng(0)
    arrays = {
        "w1": rng.standard_normal((width, 32)) * 0.3,
        "b1": np.zeros(32),
        "w2": rng.standard_normal((32, out)) * 0.1,
        "b2": np.zeros(out),
    }
    return {k: torch.tensor(v, dtype=torch.float32, device=device).requires_grad_(True)
            for k, v in arrays.items()}


def mlp(p, obs):
    return torch.tanh(torch.tanh(obs @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])


def solver_bound_ms(n_active, B, C, n, J, iterations, position_iterations, bwd):
    """The least time of one solve (or its reverse pass) on this card: the
    larger of its bytes (each input read once, each output written once)
    over the HBM rate and its float32 operations over the float32 rate.
    Operations are counted for the run's active lanes from the kernels'
    arithmetic: about 80 a lane for the setup, 45 for each normal or
    friction pass and 38 for each position pass, 60 for each joint of a
    world; the reverse pass recomputes the forward and does about twice
    its work again."""
    lane_in = C * B * (4 * 4 + 1)  # pen_x, pen_y, pt_x, pt_y float32, active uint8
    body = n * B * 4
    nbytes = lane_in + 12 * body + (6 * body + 4 * C * B * 4 if bwd else 0)
    ops = n_active * (80 + 90 * iterations + 38 * position_iterations) + 60 * J * B
    ops *= 3 if bwd else 1
    t_bytes, t_ops = nbytes / HBM_BPS, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fused_bound_ms(world, override_parts, n_active, B):
    """The least time of one fused step on this card: the larger of its
    bytes (six body planes and the terrain rows the pairs read, once; six
    body planes and the active flags written once) over the HBM rate and
    its float32 operations over the float32 rate.  Operations are counted
    from the kernel's arithmetic: every polygon pair runs its SAT and clip
    whether or not it touches (edge axes 9 each; per axis the projections
    of both polygons, 3 a vertex and 2 a min/max, then 4 to compare; 4 a
    vertex for the reference edges; about 85 for the clip and the lanes),
    every circle pair its lane (``LANE_OPS``), every rotated
    vertex 8, every body 8 to integrate and about 40 for its cosine and
    sine, and the solve and joints as ``solver_bound_ms`` counts them for
    the run's active lanes."""
    from parallax_tpu_torch.ops.fused_step import fused_operands

    ops_ = fused_operands(world)
    parts = ops_.part_i.tolist()
    per_world = 0
    for _, _, va, vb, _, _, _, kind in ops_.pair_i.tolist():
        per_world += pair_ops(va, vb, kind)
    per_world += sum(8 * nv for p, (_, _, nv) in enumerate(parts) if p not in override_parts)
    n, C, J = world.n_bodies, world.table.n_contacts, world.joints.n_joints
    per_world += 48 * n
    cfg = world.config
    ops = per_world * B + n_active * (
        80 + 90 * cfg.solver_iterations + 38 * cfg.position_iterations
    ) + 60 * J * B
    terrain_rows = sum(parts[p][2] for p in override_parts)
    nbytes = (12 * n + 2 * terrain_rows) * B * 4 + C * B
    t_bytes, t_ops = nbytes / HBM_BPS, ops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def fused_bwd_bound_ms(world, override_parts, n_active, touched, B):
    """The least time of one reverse pass of the fused step on this card:
    the larger of its bytes (the six body planes, their six cotangents and
    the terrain rows the pairs read, once; six body planes and the terrain
    planes' cotangents written once) over the HBM rate and its float32
    operations over the float32 rate.  Operations are counted from the
    kernel's arithmetic: the recompute is the forward step
    (``fused_bound_ms``), the solver's reverse pass about twice the solve
    again (``solver_bound_ms``), and each pair with an active lane (their
    counts per pair are ``touched``; the others have zero cotangents and
    are skipped) runs its lanes again and their adjoint: for a polygon pair
    its SAT and about 17 a vertex of both polygons (the projection chains
    replayed and walked back) and 160 for the clips, the tangent and the
    edge normal; for a circle pair its lane and ``LANE_BWD_OPS``."""
    from parallax_tpu_torch.geometry.shapes import MAX_VERTS
    from parallax_tpu_torch.ops.fused_step import fused_operands

    ops_ = fused_operands(world)
    parts = ops_.part_i.tolist()
    _, _, _, f_ops = fused_bound_ms(world, override_parts, n_active, B)
    n, J = world.n_bodies, world.joints.n_joints
    cfg = world.config
    solve_ops = n_active * (
        80 + 90 * cfg.solver_iterations + 38 * cfg.position_iterations
    ) + 60 * J * B
    adjoint = sum(
        t * (pair_ops(va, vb, kind) + (LANE_BWD_OPS[kind] if kind else 17 * (va + vb) + 160))
        for t, (_, _, va, vb, *_, kind) in zip(touched, ops_.pair_i.tolist())
    )
    ops = f_ops + 2 * solve_ops + adjoint
    terrain_rows = sum(parts[p][2] for p in override_parts)
    nbytes = (18 * n + 2 * terrain_rows + 2 * MAX_VERTS * len(override_parts)) * B * 4
    t_bytes, t_ops = nbytes / HBM_BPS, ops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


# float32 operations of one circle-circle, circle-box and circle-in-area
# lane (pair kinds 1, 2, 3), counted from fused_step.cuh's CcLane, CbLane and
# AreaCbLane, and of their adjoints in fused_step_bwd.cu
LANE_OPS = {1: 45, 2: 60, 3: 35}
LANE_BWD_OPS = {1: 45, 2: 50, 3: 20}


def pair_ops(va, vb, kind=0):
    """float32 operations of one pair's lanes (see fused_bound_ms): a
    polygon pair's SAT and clip (kind 0), or a circle pair's analytic lane
    (kind 1: cc, 2: cb, 3: area_cb)."""
    if kind:
        return LANE_OPS[kind]
    A = va + vb
    return 9 * A + A * (3 * A + 2 * (A - 2) + 4) + 4 * A + 85


def touched_pairs(world, active):
    """Per pair of the table, the worlds where one of its lanes is active."""
    from parallax_tpu_torch.ops.fused_step import _width, fused_operands

    out = []
    for (*_, lane, kind), g in zip(fused_operands(world).pair_i.tolist(),
                                   [g for g in world.table.groups for _ in g.part_a]):
        out.append(int(active[lane:lane + _width(g.kernel)].any(0).sum()))
    return out


def circle_params(width, device, out=2):
    """A tanh-linear policy's weights for an env of ``width`` observations
    and ``out`` actions (numpy, seeded)."""
    rng = np.random.default_rng(12)
    W = (rng.standard_normal((width, out)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(out) * 0.3).astype(np.float32)
    return torch.from_numpy(W).to(device), torch.from_numpy(b).to(device)


def circle_policy(params, obs):
    return torch.tanh(obs @ params[0] + params[1])


def billiards_start(env, keys):
    """Fresh racks; the cue of every fourth world heads for the top-right
    pocket (``tests/test_billiards.py:95``), and that of the next world is
    shot into the rack at 3 m/s with a numpy-seeded spread."""
    st = env.reset_fn_batch(keys)
    pos, vel = st.bodies.pos.clone(), st.bodies.vel.clone()
    w = np.arange(keys.shape[0])
    scratch = torch.from_numpy(w % 4 == 0).to(keys.device)
    brk = torch.from_numpy(w % 4 == 1).to(keys.device)
    spread = np.random.default_rng(9).standard_normal((keys.shape[0], 2)).astype(np.float32)
    shot = torch.tensor([3.0, 0.0], device=keys.device) + 0.05 * torch.from_numpy(spread).to(
        keys.device)
    pos[:, 0] = torch.where(scratch[:, None], torch.tensor([0.85, 0.42], device=keys.device),
                            pos[:, 0])
    vel[:, 0] = torch.where(scratch[:, None], torch.tensor([1.5, 0.8], device=keys.device),
                            torch.where(brk[:, None], shot, vel[:, 0]))
    return st._replace(bodies=st.bodies._replace(pos=pos, vel=vel))


def circle_worlds(env_b, gpu):
    """Phase 5b: the circle worlds' paths at B, each with its launches,
    env-steps/s, peak memory and the time of its layers, then billiards8
    card against CPU.  Returns ``{path: (env-steps/s, (solver, fused
    launches), peak GiB)}``; what the paths allocate is freed on return, so
    later peaks do not count it."""
    from parallax_tpu_torch.engine.batched import collide_batched
    from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
    from parallax_tpu_torch.envs.bouncer import Bouncer
    from parallax_tpu_torch.ops import contact_solver, fused_step
    from parallax_tpu_torch.utils import prng

    dev = torch.device("cuda")
    circle = {}
    paths = (
        ("bouncer split", Bouncer(), "split"),
        ("billiards8 split", Billiards(), "split"),
        ("billiards8 fused", env_b, "fused"),
        ("billiards48 split", Billiards(BilliardsConfig(n_object=47)), "split"),
    )
    for label, e, kind in paths:
        cp = circle_params(e.observation_size, dev)
        st = e.reset_fn_batch(keys_for(B, 8, dev))
        e.rollout_batch(st, circle_policy, 2, cp)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        contact_solver.launches = fused_step.launches = 0
        t0 = time.perf_counter()
        _, tr = e.rollout_batch(st, circle_policy, CIRCLE_STEPS, cp)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = (contact_solver.launches, fused_step.launches)
        want_counts = (CIRCLE_STEPS, 0) if kind == "split" else (0, CIRCLE_STEPS)
        check(counts == want_counts, f"{label}: launches (solver, fused) {counts}, want {want_counts}")
        check(tuple(tr.obs.shape) == (CIRCLE_STEPS, B, e.observation_size),
              f"{label}: obs shape {tuple(tr.obs.shape)}")
        check(torch.isfinite(tr.obs).all().item() and torch.isfinite(tr.reward).all().item(),
              f"{label}: non-finite obs or reward")
        peak = torch.cuda.max_memory_allocated() / 2**30
        circle[label] = (B * CIRCLE_STEPS / sec, counts, peak)
        print(f"[main] {label} rollout_batch B={B} x {CIRCLE_STEPS} steps ({e.world.n_bodies} "
              f"bodies, C={e.world.table.n_contacts}): launches solver {counts[0]}, fused "
              f"{counts[1]}, {B * CIRCLE_STEPS / sec:.1f} env-steps/s, peak memory {peak:.2f} "
              f"GiB, on {gpu}")
        # where a step's time goes: the step, and the layers it calls
        ps = e._to_planes(st)
        acts = circle_policy(cp, e.plane_obs(ps.s, ps.aux))
        s1 = e.plane_pre(ps.s, ps.aux, acts)
        layers = {"step (_step_planes)": lambda: e._step_planes(ps, acts),
                  "plane_fresh (reset draw)": lambda: e.plane_fresh(prng.split(ps.key)[:, 0])}
        if kind == "split":
            con1 = collide_batched(e.world, s1)
            wc = e.world.config
            layers["collide_batched"] = lambda: collide_batched(e.world, s1)
            layers["solve+joints kernel"] = lambda: contact_solver.solve_contacts(
                e.world, s1, con1, wc.solver_iterations, wc.position_iterations, wc.dt,
                wc.contact)
        else:
            layers["fused step kernel"] = lambda: fused_step.physics_core_fused(e.world, s1)
        for name_, fn in layers.items():
            cuda_ms(fn, 2)
            print(f"[time] {label}: {name_} {cuda_ms(fn, 5):.4f} ms per call at B={B} on {gpu}")
        del tr, ps, acts, s1, layers  # the next path's peak memory is its own

    # billiards8 on the card against the CPU, split and fused: cues
    # scratched into a pocket in a quarter of the worlds, broken into the
    # rack in another quarter
    for label, bcfg in (("split", BilliardsConfig()),
                        ("fused", BilliardsConfig(use_cuda_fused=True))):
        small = {}
        for d in ("cuda", "cpu"):
            e = Billiards(bcfg, device=d)
            st = billiards_start(e, keys_for(SMALL_B, 4, d))
            _, small[d] = e.rollout_batch(st, circle_policy, SMALL_STEPS,
                                          circle_params(e.observation_size, d))
        g, c = small["cuda"], small["cpu"]
        obs_err = (g.obs.cpu() - c.obs).abs().max().item()
        rew_err = (g.reward.cpu() - c.reward).abs().max().item()
        done_share = (g.done.cpu() == c.done).all(0).double().mean().item()
        dones = int(c.done.sum())
        print(f"[check] billiards8 {label} B={SMALL_B} x {SMALL_STEPS} steps, card vs CPU: max "
              f"|obs diff| {obs_err:.3e}, max |reward diff| {rew_err:.3e}, worlds with equal "
              f"done sequences {done_share:.4f} ({dones} dones on the CPU)")
        check(dones > 0, f"billiards8 {label}: no episode ended")
        check(obs_err <= CPU_ATOL and rew_err <= CPU_ATOL,
              f"billiards8 {label}: card vs CPU rollout differ beyond {CPU_ATOL}")
        check(done_share >= CPU_DONE_SHARE,
              f"billiards8 {label}: done sequences agree in {done_share} of worlds")

    return circle


def zero_policy(_, obs):
    return torch.zeros((obs.shape[0], 2), device=obs.device)


def lowered(state, device):
    b = state.bodies
    return state._replace(bodies=b._replace(
        pos=b.pos - torch.tensor([0.0, 6.2], device=device),
        vel=b.vel - torch.tensor([0.0, 0.6], device=device),
    ))


def cuda_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def turns(fn, plain, reps):
    """Device times of a kernel and its plain version, in turns after a
    warm-up: ``(best kernel ms, best plain ms, the four readings)``."""
    for f in (fn, plain):
        cuda_ms(f, 3)  # warm-up
    t = [cuda_ms(f, reps) for f in (fn, plain, fn, plain)]
    return min(t[0], t[2]), min(t[1], t[3]), t


# the circle worlds' overlap states (tests/torch_scenarios.py): edge_x,
# spacing, y_step, so that ball-ball and ball-wall lanes fire
CIRCLE_OVERLAP = {"bouncer": (2.0, 0.25, 0.1), "billiards8": (1.0, 0.03, 0.02),
                  "billiards48": (1.0, 0.03, 0.02)}


def circle_solves(gpu):
    """Phase 3: the solve+joints kernel against its plain version on the
    circle worlds' split paths, at their own shapes (one lane a pair, no
    manifold partner; billiards48 has 52 bodies and 1320 lanes), on the
    same CUDA tensors: each world's overlap state at B through
    ``collide_batched``.  Both cc and cb lanes must be active and every body
    plane within ATOL.  Returns ``{world: entry}`` with the agreement, the
    times and the bound."""
    from parallax_tpu_torch.engine.batched import collide_batched
    from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
    from parallax_tpu_torch.envs.bouncer import Bouncer
    from parallax_tpu_torch.ops import contact_solver
    from torch_scenarios import overlap_state

    out = {}
    for label, e in (("bouncer", Bouncer()), ("billiards8", Billiards()),
                     ("billiards48", Billiards(BilliardsConfig(n_object=47)))):
        w, c = e.world, e.world.config
        check([g.kernel for g in w.table.groups] == ["cc", "cb"], f"{label}'s groups")
        s = overlap_state(e, B, 3, *CIRCLE_OVERLAP[label])
        con = collide_batched(w, s)
        n_cc = w.table.groups[0].size
        cc, cb = int(con.active[:n_cc].sum()), int(con.active[n_cc:].sum())
        check(cc > 0 and cb > 0, f"{label} scenario: {cc} cc and {cb} cb lanes active, "
              "need both > 0")
        args = (c.solver_iterations, c.position_iterations, c.dt, c.contact)
        got = contact_solver.solve_contacts(w, s, con, *args)
        want = contact_solver.solve_contacts_plain(w, s, con, *args)
        torch.cuda.synchronize()
        err = 0.0
        for f, a, b in zip(got._fields, got, want):
            d = (a - b).abs().max().item()
            check(np.isfinite(d) and d <= ATOL, f"solve kernel vs plain on {label}: {f} "
                  f"differs by {d}")
            err = max(err, d)
        ms, plain_ms, t = turns(lambda: contact_solver.solve_contacts(w, s, con, *args),
                                lambda: contact_solver.solve_contacts_plain(w, s, con, *args),
                                3 if label == "billiards48" else 10)
        n, C, J = w.n_bodies, w.table.n_contacts, w.joints.n_joints
        bound, by = solver_bound_ms(cc + cb, B, C, n, J, c.solver_iterations,
                                    c.position_iterations, bwd=False)
        print(f"[kernel] contact_solve_fwd vs plain on {label} at B={B} ({n} bodies, C={C}): "
              f"{cc} cc and {cb} cb lanes active, max |diff| {err:.3e} <= {ATOL}")
        print(f"[time] solve+joints per call on {label} at B={B}: kernel {ms:.4f} ms, plain "
              f"torch {plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}) on {gpu}")
        print(f"[bound] solve+joints on {label} at B={B}, {cc + cb} active lanes: {bound:.5f} "
              f"ms ({by})")
        out[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by, "active_cc": cc, "active_cb": cb}
        del s, con, got, want
    return out


def hold_vjp(label, got, want, bar=True, ulps=0):
    """The largest error of a reverse pass against its plain VJP over the
    cotangent planes, and its share of the bar ``ATOL + RTOL * |want|``
    (plus ``ulps`` float32 ulps of the plane's largest ``|want|``); fail on
    a non-finite value on either side, and with ``bar`` beyond the bar."""
    err = share = 0.0
    for a, b in zip(got, want):
        if not a.numel():
            continue
        check(bool(torch.isfinite(a).all() & torch.isfinite(b).all()),
              f"{label}: non-finite cotangent")
        d = (a - b).abs()
        err = max(err, d.max().item())
        slack = ulps * torch.finfo(torch.float32).eps * b.abs().max()
        share = max(share, (d / (ATOL + RTOL * b.abs() + slack)).max().item())
    if bar:
        check(share <= 1.0, f"{label}: differs from the plain VJP by {err} ({share:.2f} of the bar)")
    return err, share


def within_1e3(planes, ref):
    """``[B]`` bool: the worlds where every plane of ``planes`` is within
    1e-5 + 1e-3 |r| of its float64 reference ``r`` in ``ref``."""
    ok = torch.ones(ref[0].shape[-1], dtype=torch.bool, device=ref[0].device)
    for a, b in zip(planes, ref):
        ok &= ((a.double() - b).abs() <= 1e-5 + 1e-3 * b.abs()).all(0)
    return ok


def float64_reading(got, want, want64):
    """How many worlds the reverse pass ``got`` and the plain float32 VJP
    ``want`` each leave more than 1e-3 off the plain float64 VJP
    ``want64`` (``within_1e3``): a world falls out where one of its lanes
    sits so near a kink (a clamp or a max switching its branch) that
    float32 rounding may cross it.  A reading, with no bar: ``(kernel's
    count, plain's count)``."""
    n = want64[0].shape[-1]
    return n - int(within_1e3(got, want64).sum()), n - int(within_1e3(want, want64).sum())


def fused_vjp64(world, s, cot):
    """The plain float64 VJP of the fused step's body planes."""
    from parallax_tpu_torch.ops import fused_step

    return fused_step.fused_step_bwd_plain(world, type(s)(*(x.double() for x in s)), None,
                                           type(s)(*(x.double() for x in cot)))[0]


def robocup_start(env, batch, seed):
    """RoboCup states with the overlap scenario's planes
    (``tests/torch_scenarios.py``, every lane kind fires), and in every
    fourth world the ball shot from (-4.3, 0) or (4.3, 0) into the goal
    behind it at 3 m/s, so that episodes end and reset."""
    from parallax_tpu_torch.engine.batched import _from_soa
    from torch_scenarios import robocup_overlap_state

    dev = env.device
    st = env.reset_fn_batch(keys_for(batch, seed, dev))
    s = robocup_overlap_state(env, batch, seed)
    w = torch.arange(batch, device=dev)
    shot = w % 4 == 0
    side = torch.where(w % 8 == 0, -1.0, 1.0)
    bi = env.ball_idx

    def ball(x, v):
        x = x.clone()
        x[bi] = torch.where(shot, v, x[bi])
        return x

    s = s._replace(px=ball(s.px, 4.3 * side), py=ball(s.py, 0.0 * side),
                   vx=ball(s.vx, 3.0 * side), vy=ball(s.vy, 0.0 * side))
    return st._replace(bodies=_from_soa(s))


def robocup_kernels(env_b, gpu):
    """Phase 3 on RoboCup's shapes (11 bodies; C=70 lanes, one a pair, no
    partner: 21 cc, 42 cb, 7 area_cb) at B: the fused kernel and its
    reverse pass against their plain versions on the overlap state, the
    reverse pass on billiards8 (its pairs state and its pile) and at the cb
    and area_cb tie cases (B=1), and the solve kernel and its reverse pass
    on the overlap state's lanes.  Returns ``{entry: results}``."""
    from parallax_tpu_torch.engine.batched import collide_batched, integrate_bm
    from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig
    from parallax_tpu_torch.ops import contact_solver, fused_step
    from torch_scenarios import (active_kinds, area_tie_case, billiards_pairs_state, cb_tie_case,
                                 cotangents, overlap_state, robocup_overlap_state)

    dev = torch.device("cuda")
    out = {}
    env_r = RoboCup(RoboCupConfig(use_cuda_fused=True))
    w = env_r.world
    s = robocup_overlap_state(env_r, B, 0)
    got_s, got_c = fused_step.physics_core_fused(w, s)
    want_s, want_c = fused_step.fused_step_plain(w, s)
    torch.cuda.synchronize()
    kinds = active_kinds(w, want_c.active)
    check(set(kinds) == {"cc", "cb", "area_cb"} and min(kinds.values()) > 0,
          f"RoboCup scenario: active lanes {kinds}")
    check(torch.equal(got_c.active, want_c.active),
          f"fused lanes vs plain on RoboCup: {int((got_c.active != want_c.active).sum())} flags differ")
    err = 0.0
    for f, a, b in zip(got_s._fields, got_s, want_s):
        d = (a - b).abs().max().item()
        check(np.isfinite(d) and d <= ATOL, f"fused kernel vs plain on RoboCup: {f} differs by {d}")
        err = max(err, d)
    ms, plain_ms, t = turns(lambda: fused_step.physics_core_fused(w, s),
                            lambda: fused_step.fused_step_plain(w, s), 20)
    n_act = sum(kinds.values())
    bound, by, nbytes, ops = fused_bound_ms(w, [], n_act, B)
    print(f"[kernel] fused_step_fwd (cc, cb, area_cb lanes) vs plain on RoboCup at B={B}: active "
          f"lanes {kinds}, flags identical, max |diff| {err:.3e} <= {ATOL}")
    print(f"[time] fused step per call on RoboCup at B={B}: kernel {ms:.4f} ms, plain torch "
          f"{plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}) on {gpu}")
    print(f"[bound] fused step on RoboCup at B={B}, {n_act} active lanes: {bound:.5f} ms ({by}; "
          f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M float32 operations)")
    out["fwd"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                  "bound_by": by, "active": kinds}

    cot = cotangents(w.n_bodies, B, 5, dev)
    got = fused_step.fused_step_bwd(w, s, None, cot)[0]
    want = fused_step.fused_step_bwd_plain(w, s, None, cot)[0]
    torch.cuda.synchronize()
    err, share = hold_vjp("fused_step_bwd on RoboCup", got, want)
    off = float64_reading(got, want, fused_vjp64(w, s, cot))
    print(f"[kernel] fused_step_bwd (cc, cb, area_cb lanes) vs plain VJP on RoboCup at B={B}: max "
          f"|diff| {err:.3e}, {share:.3f} of the bar (rtol {RTOL}, atol {ATOL}); worlds off the "
          f"float64 VJP by more than 1e-3: kernel {off[0]}, plain float32 {off[1]}")
    check(all(x.abs().max().item() > 0 for x in got[:4]), "fused reverse pass on RoboCup: a dead plane")
    ms, plain_ms, t = turns(lambda: fused_step.fused_step_bwd(w, s, None, cot),
                            lambda: fused_step.fused_step_bwd_plain(w, s, None, cot), 5)
    touched = touched_pairs(w, want_c.active)
    bound, by, nbytes, ops = fused_bwd_bound_ms(w, [], n_act, touched, B)
    print(f"[time] fused reverse pass per call on RoboCup at B={B}: kernel {ms:.4f} ms, plain "
          f"autograd {plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}) on {gpu}")
    print(f"[bound] fused reverse pass on RoboCup at B={B}, {sum(touched)} pairs touching: "
          f"{bound:.5f} ms ({by}; {nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M float32 operations)")
    out["bwd"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                  "bound_by": by}

    # billiards8's reverse pass: its pairs state within the bar, and its
    # pile, whose float32 VJP has lanes near kinks, read with no bar
    wb = env_b.world
    cot_b = cotangents(wb.n_bodies, B, 5, dev)
    for label, sb in (("pairs", billiards_pairs_state(env_b, B)),
                      ("pile", overlap_state(env_b, B, 3, 1.0, 0.03, 0.02))):
        got = fused_step.fused_step_bwd(wb, sb, None, cot_b)[0]
        want = fused_step.fused_step_bwd_plain(wb, sb, None, cot_b)[0]
        torch.cuda.synchronize()
        act = active_kinds(wb, fused_step.fused_step_plain(wb, sb)[1].active)
        barred = label == "pairs"
        err, share = hold_vjp(f"fused_step_bwd on billiards8's {label} state", got, want, barred)
        off = float64_reading(got, want, fused_vjp64(wb, sb, cot_b))
        print(f"[kernel] fused_step_bwd (cc, cb lanes) vs plain VJP on billiards8's {label} state at "
              f"B={B}: active lanes {act}, max |diff| {err:.3e}, {share:.3f} of the bar"
              f"{'' if barred else ' (a reading, no bar)'}; worlds off the float64 VJP by more "
              f"than 1e-3: kernel {off[0]}, plain float32 {off[1]}")
        if label == "pairs":
            ms, plain_ms, t = turns(lambda: fused_step.fused_step_bwd(wb, sb, None, cot_b),
                                    lambda: fused_step.fused_step_bwd_plain(wb, sb, None, cot_b), 5)
            with torch.no_grad():
                act_b = fused_step.fused_step_plain(wb, sb)[1].active
            touched = touched_pairs(wb, act_b)
            bound, by, nbytes, ops = fused_bwd_bound_ms(wb, [], int(act_b.sum()), touched, B)
            print(f"[time] fused reverse pass per call on billiards8 at B={B}: kernel {ms:.4f} ms, "
                  f"plain autograd {plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}) on {gpu}")
            print(f"[bound] fused reverse pass on billiards8 at B={B}: {bound:.5f} ms ({by}; "
                  f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M float32 operations)")
            out["bwd_billiards8"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                     "bound_ms": bound, "bound_by": by}
        else:
            out["bwd_billiards8"]["pile_max_abs_err"] = err

    tie = 0.0
    for e, case in ((env_b, cb_tie_case), (env_r, area_tie_case)):
        ts, tcot = case(e, dev)
        got = fused_step.fused_step_bwd(e.world, ts, None, tcot)[0]
        want = fused_step.fused_step_bwd_plain(e.world, ts, None, tcot)[0]
        torch.cuda.synchronize()
        err, _ = hold_vjp(f"fused_step_bwd at the {case.__name__}", got, want)
        check(got.px.abs().max().item() > 0.1, f"{case.__name__}: a dead plane")
        tie = max(tie, err)
    print(f"[kernel] tie cases (B=1: the cue's centre on a cushion's face, the clamp of the cb lane; "
          f"RoboCup's ball touching the field's side, a floor of the area_cb lane): fused_step_bwd "
          f"max |diff| {tie:.3e} vs the plain VJP (rtol {RTOL}, atol {ATOL})")
    out["bwd"]["max_abs_err"] = max(out["bwd"]["max_abs_err"], tie)

    # rows 1 and 2 at RoboCup's shapes: the split step's lanes of the state
    env_s = RoboCup()
    ws, c = env_s.world, env_s.world.config
    si, _ = integrate_bm(ws, s)
    con = collide_batched(ws, si)
    args = (c.solver_iterations, c.position_iterations, c.dt, c.contact)
    got = contact_solver.solve_contacts(ws, si, con, *args)
    want = contact_solver.solve_contacts_plain(ws, si, con, *args)
    torch.cuda.synchronize()
    err = 0.0
    for f, a, b in zip(got._fields, got, want):
        d = (a - b).abs().max().item()
        check(np.isfinite(d) and d <= ATOL, f"solve kernel vs plain on RoboCup: {f} differs by {d}")
        err = max(err, d)
    got = contact_solver.solve_contacts_bwd(ws, si, con, cot, *args)
    want = contact_solver.solve_contacts_bwd_plain(ws, si, con, cot, *args)
    torch.cuda.synchronize()
    # the body planes and the contact points' cotangents at the bar.  The
    # penetrations' are each a sum of terms the size of the solver's
    # impulse cotangents (some 100s here) that cancels to near 0 at a face
    # contact's zero component, so the two float32 VJPs differ there by an
    # ulp of those terms (2^-16 to 2^-13), over the bar: they are held at
    # the bar plus PEN_ULPS ulps of each plane's largest value, and the
    # float64 VJP shows both float32 VJPs equally far from it
    berr, bshare = hold_vjp("contact_solve_bwd on RoboCup", (*got[0], *got[3:]),
                            (*want[0], *want[3:]))
    pen_err, pen_share = hold_vjp("contact_solve_bwd on RoboCup: pen", got[1:3], want[1:3],
                                  ulps=PEN_ULPS)
    _, pen_elem = hold_vjp("contact_solve_bwd on RoboCup: pen", got[1:3], want[1:3], False)
    def d64(x):
        return x.double() if x.is_floating_point() else x

    want64 = contact_solver.solve_contacts_bwd_plain(
        ws, type(si)(*map(d64, si)), type(con)(*map(d64, con)), type(cot)(*map(d64, cot)), *args)
    off64 = [max((a.double() - r).abs().max().item() for a, r in zip(x[1:3], want64[1:3]))
             for x in (got, want)]
    off = float64_reading((*got[0], *got[1:]), (*want[0], *want[1:]),
                          (*want64[0], *want64[1:]))
    print(f"[kernel] contact_solve_bwd vs plain VJP on RoboCup at B={B}: body planes and contact "
          f"points max |diff| {berr:.3e}, {bshare:.3f} of the bar; penetrations max |diff| "
          f"{pen_err:.3e}, {pen_share:.3f} of the bar plus {PEN_ULPS} ulps of each plane's largest "
          f"value ({pen_elem:.2f} of the bar alone, a reading); float64 VJP: penetrations off it by "
          f"up to {off64[0]:.3e} (kernel) and {off64[1]:.3e} (plain float32), worlds off it by more "
          f"than 1e-3: kernel {off[0]}, plain float32 {off[1]}")
    berr = max(berr, pen_err)
    n_act = int(con.active.sum())
    counts = (n_act, B, ws.table.n_contacts, ws.n_bodies, 0, c.solver_iterations,
              c.position_iterations)
    for key, e_, fn, plain, reps in (
            ("solve", err, lambda: contact_solver.solve_contacts(ws, si, con, *args),
             lambda: contact_solver.solve_contacts_plain(ws, si, con, *args), 10),
            ("solve_bwd", berr, lambda: contact_solver.solve_contacts_bwd(ws, si, con, cot, *args),
             lambda: contact_solver.solve_contacts_bwd_plain(ws, si, con, cot, *args), 5)):
        ms, plain_ms, t = turns(fn, plain, reps)
        bound, by = solver_bound_ms(*counts, bwd=key == "solve_bwd")
        print(f"[kernel] contact_{key} vs plain on RoboCup at B={B} ({ws.n_bodies} bodies, C=70, no "
              f"partner): {n_act} active lanes, max |diff| {e_:.3e}"
              + ("" if key == "solve_bwd" else f" <= {ATOL}"))
        print(f"[time] contact_{key} per call on RoboCup at B={B}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}); bound {bound:.5f} ms ({by}) "
              f"on {gpu}")
        out[key] = {"max_abs_err": e_, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                    "bound_by": by}
    return out


def cue_loss_fn(env, horizon, segments):
    """A state objective for billiards8: minus the cue's mean x after a
    ``horizon``-step rollout of ``mlp``, through the rollout's entry point.
    Billiards' reward (pot counts and a constant) has no gradient path, so
    its ``make_train_step`` gradient is zero, in the JAX package as in the
    port, and no reverse pass runs; this objective, which is not
    billiards' train step, puts the fused reverse pass on billiards8."""
    from parallax_tpu_torch.parallel import rollout

    def loss_fn(params, states):
        final, _ = rollout.batched_rollout(env, states, mlp, params, horizon, segments,
                                           traj_select=lambda ts: ts.reward)
        return -final.bodies.pos[:, 0, 0].mean(), (final, None)

    return loss_fn


def robocup_card_vs_cpu(env_b):
    """Phases 4 and 6 on RoboCup, B=1024: split and fused rollouts of 60
    steps from ``robocup_start`` (obs and reward within CPU_ATOL, done
    sequences in CPU_DONE_SHARE of the worlds), and the split and fused
    train loss and grads at h=12 from the same start against the CPU's
    split step (LOSS_RTOL, GRAD_RTOL); billiards8's fused gradient of
    ``cue_loss_fn`` from its pairs state at the same bars."""
    from parallax_tpu_torch.engine.batched import _from_soa
    from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
    from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig
    from parallax_tpu_torch.parallel import rollout
    from parallax_tpu_torch.utils.pytree import tree_map
    from torch_scenarios import billiards_pairs_state

    for label, rcfg in (("split", RoboCupConfig()), ("fused", RoboCupConfig(use_cuda_fused=True))):
        small = {}
        for d in ("cuda", "cpu"):
            e = RoboCup(rcfg, device=d)
            st = robocup_start(e, SMALL_B, 4)
            _, small[d] = e.rollout_batch(
                st, circle_policy, SMALL_STEPS, circle_params(e.observation_size, e.device,
                                                              e.action_size))
        g, c = small["cuda"], small["cpu"]
        obs_err = (g.obs.cpu() - c.obs).abs().max().item()
        rew_err = (g.reward.cpu() - c.reward).abs().max().item()
        done_share = (g.done.cpu() == c.done).all(0).double().mean().item()
        goals = int(c.terminated.sum())
        print(f"[check] RoboCup {label} B={SMALL_B} x {SMALL_STEPS} steps, card vs CPU: max |obs "
              f"diff| {obs_err:.3e}, max |reward diff| {rew_err:.3e}, worlds with equal done "
              f"sequences {done_share:.4f} ({goals} goals on the CPU)")
        check(goals > 0, f"RoboCup {label}: no goal")
        check(obs_err <= CPU_ATOL and rew_err <= CPU_ATOL,
              f"RoboCup {label}: card vs CPU rollout differ beyond {CPU_ATOL}")
        check(done_share >= CPU_DONE_SHARE,
              f"RoboCup {label}: done sequences agree in {done_share} of worlds")

    def loss_grads(e, st, make=rollout.make_loss_fn):
        p = mlp_params(e.device, e.observation_size, e.action_size)
        loss, _ = make(e, mlp, SMALL_H, 2)(p, st) if make is rollout.make_loss_fn \
            else make(e, SMALL_H, 2)(p, st)
        return loss.item(), [x.cpu() for x in torch.autograd.grad(loss, list(p.values()))]

    def compare(label, ref, e, make=rollout.make_loss_fn):
        st = tree_map(lambda x: x.to(e.device), ref[0])
        loss_g, grads_g = loss_grads(e, st, make)
        loss_c, grads_c = ref[1]
        loss_rel = abs(loss_g - loss_c) / abs(loss_c)
        grad_rel = max((a - b).norm().item() / b.norm().item() for a, b in zip(grads_g, grads_c))
        print(f"[check] {label} train loss+grads B={SMALL_B} h={SMALL_H}, card vs CPU: loss "
              f"{loss_g:.9f} vs {loss_c:.9f} (rel {loss_rel:.2e}), policy grads max rel diff in "
              f"norm {grad_rel:.2e}")
        check(loss_rel <= LOSS_RTOL, f"{label} train loss: card vs CPU rel diff {loss_rel}")
        check(grad_rel <= GRAD_RTOL, f"{label} policy grads: card vs CPU rel diff {grad_rel}")
        check(all(g.norm().item() > 0 for g in grads_g), f"{label}: a policy gradient is zero")

    cpu = RoboCup(device="cpu")
    st = robocup_start(cpu, SMALL_B, 6)
    ref = (st, loss_grads(cpu, st))
    compare("RoboCup split", ref, RoboCup())
    compare("RoboCup fused", ref, RoboCup(RoboCupConfig(use_cuda_fused=True)))
    cpu_b = Billiards(device="cpu")
    st = cpu_b.reset_fn_batch(keys_for(SMALL_B, 6, "cpu"))
    st = st._replace(bodies=_from_soa(billiards_pairs_state(cpu_b, SMALL_B)))
    compare("billiards8 fused (cue objective)", (st, loss_grads(cpu_b, st, cue_loss_fn)), env_b,
            cue_loss_fn)


def robocup_paths(gpu):
    """Phase 5b on RoboCup at full width, B: split and fused rollouts of
    STEPS steps from ``robocup_start`` with their launches, env-steps/s,
    peak memory and the time of their layers.  Returns ``{path: (env-steps/s,
    (solver, fused launches), peak GiB)}``."""
    from parallax_tpu_torch.engine.batched import collide_batched
    from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig
    from parallax_tpu_torch.ops import contact_solver, fused_step
    from parallax_tpu_torch.utils import prng

    dev = torch.device("cuda")
    res = {}
    for label, e in (("robocup split", RoboCup()),
                     ("robocup fused", RoboCup(RoboCupConfig(use_cuda_fused=True)))):
        cp = circle_params(e.observation_size, dev, e.action_size)
        st = robocup_start(e, B, 8)
        e.rollout_batch(st, circle_policy, 2, cp)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        contact_solver.launches = fused_step.launches = 0
        t0 = time.perf_counter()
        _, tr = e.rollout_batch(st, circle_policy, STEPS, cp)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = (contact_solver.launches, fused_step.launches)
        want = (STEPS, 0) if label.endswith("split") else (0, STEPS)
        check(counts == want, f"{label}: launches (solver, fused) {counts}, want {want}")
        check(tuple(tr.obs.shape) == (STEPS, B, e.observation_size),
              f"{label}: obs shape {tuple(tr.obs.shape)}")
        check(torch.isfinite(tr.obs).all().item() and torch.isfinite(tr.reward).all().item(),
              f"{label}: non-finite obs or reward")
        goals = int(tr.terminated.sum())
        check(goals > 0, f"{label}: no goal")
        peak = torch.cuda.max_memory_allocated() / 2**30
        res[label] = (B * STEPS / sec, counts, peak)
        print(f"[main] {label} rollout_batch B={B} x {STEPS} steps (11 bodies, C=70): launches "
              f"solver {counts[0]}, fused {counts[1]}, {goals} goals, {B * STEPS / sec:.1f} "
              f"env-steps/s, peak memory {peak:.2f} GiB, on {gpu}")
        ps = e._to_planes(st)
        acts = circle_policy(cp, e.plane_obs(ps.s, ps.aux))
        s1 = e.plane_pre(ps.s, ps.aux, acts)
        layers = {"step (_step_planes)": lambda: e._step_planes(ps, acts),
                  "plane_fresh (reset draw)": lambda: e.plane_fresh(prng.split(ps.key)[:, 0]),
                  "plane_pre + plane_post": lambda: e.plane_post(
                      e.plane_pre(ps.s, ps.aux, acts), ps.aux, None, acts, ps.t + 1)}
        if label.endswith("split"):
            con1 = collide_batched(e.world, s1)
            wc = e.world.config
            layers["collide_batched"] = lambda: collide_batched(e.world, s1)
            layers["solve+joints kernel"] = lambda: contact_solver.solve_contacts(
                e.world, s1, con1, wc.solver_iterations, wc.position_iterations, wc.dt, wc.contact)
        else:
            layers["fused step kernel"] = lambda: fused_step.physics_core_fused(e.world, s1)
        for name_, fn in layers.items():
            cuda_ms(fn, 2)
            print(f"[time] {label}: {name_} {cuda_ms(fn, 5):.4f} ms per call at B={B} on {gpu}")
        del tr, ps, acts, s1, layers
    return res


def robocup_train(env_b, gpu):
    """Phase 7 on RoboCup and billiards8: ``make_train_step`` at B,
    HORIZON, SEGMENTS and the 32-wide tanh MLP with Adam 3e-3 (``bench.py
    --train``), one timed step of each path after a warm-up: RoboCup split
    and fused, and billiards8 fused with ``cue_loss_fn`` in place of its
    reward.  Returns ``{path: (s, launches, peak)}`` with the launches as
    (solver fwd, bwd, fused fwd, bwd)."""
    from parallax_tpu_torch.utils.pytree import tree_map

    def cue_step(e, opt):
        loss_fn = cue_loss_fn(e, HORIZON, SEGMENTS)

        def step(params, states):
            opt.zero_grad(set_to_none=True)
            loss, (final, _) = loss_fn(params, states)
            loss.backward()
            opt.step()
            return params, tree_map(torch.Tensor.detach, final), {"loss": loss.detach()}

        return step

    from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig
    from parallax_tpu_torch.ops import contact_solver, fused_step
    from parallax_tpu_torch.parallel import rollout

    dev = torch.device("cuda")
    res = {}
    for label, e in (("robocup split", RoboCup()),
                     ("robocup fused", RoboCup(RoboCupConfig(use_cuda_fused=True))),
                     ("billiards8 fused cue objective", env_b)):
        params = mlp_params(dev, e.observation_size, e.action_size)
        opt = rollout.adam(params, 3e-3)
        step = (cue_step(e, opt) if label.startswith("billiards") else
                rollout.make_train_step(e, mlp, opt, HORIZON, checkpoint_segments=SEGMENTS))
        states = e.reset_fn_batch(keys_for(B, 7, dev))
        params, states, m = step(params, states)  # warm-up
        check(np.isfinite(m["loss"].item()), f"{label} warm-up train step: non-finite loss")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        contact_solver.launches = contact_solver.bwd_launches = 0
        fused_step.launches = fused_step.bwd_launches = 0
        t0 = time.perf_counter()
        params, states, m = step(params, states)
        loss = m["loss"].item()  # synchronizes
        sec = time.perf_counter() - t0
        counts = (contact_solver.launches, contact_solver.bwd_launches,
                  fused_step.launches, fused_step.bwd_launches)
        want = ((2 * HORIZON, HORIZON, 0, 0) if label.endswith("split")
                else (0, 0, 2 * HORIZON, HORIZON))
        check(np.isfinite(loss), f"{label} train step: non-finite loss {loss}")
        check(counts == want, f"{label} train step: launches {counts}, want {want}")
        check(all(torch.isfinite(p).all().item() for p in params.values()),
              f"{label} train step: non-finite params")
        peak = torch.cuda.max_memory_allocated() / 2**30
        res[label] = (sec, counts, peak)
        print(f"[train] {label} step B={B} h={HORIZON} segments={SEGMENTS}: loss {loss:.6f}, "
              f"{sec:.3f} s, {B * HORIZON / sec:.1f} env-steps/s, launches solver fwd {counts[0]} "
              f"bwd {counts[1]}, fused fwd {counts[2]} bwd {counts[3]}, peak memory {peak:.2f} "
              f"GiB, on {gpu}")
        del step, opt, params, states, m
    return res


def profile_train(label, loss_fn, params, states, gpu):
    """One short train step (forward + backward) under ``torch.profiler``,
    its kernels already warm from the full-width steps: device kernels,
    their summed time, the wall time of the forward and of the backward,
    and the kernels that take the most device time.  The profiler slows
    the host's launches, so the busy share it shows is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # device activity only: the host events of 46k launches take long to collect
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, _ = loss_fn(params, states)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
        fwd_us = 1e6 * (t1 - t0)
    for p in params.values():
        p.grad = None
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    count = sum(n for n, _ in by_name.values())
    busy = sum(t for _, t in by_name.values())
    check(count > 0, "the profiler saw no device kernels")
    print(f"[profile] {label} train step B={B} h={PROFILE_H} (2 segments): {count} device kernels, "
          f"{busy / 1e3:.2f} ms device time in {wall_us / 1e3:.2f} ms wall (forward "
          f"{fwd_us / 1e3:.2f} ms, backward {(wall_us - fwd_us) / 1e3:.2f} ms), busy "
          f"{busy / wall_us:.3f} of it, on {gpu}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    for name, (n, t) in top:
        print(f"[profile]   {t / 1e3:9.3f} ms in {n:6d} launches: {name[:90]}")


def main():
    t_start = time.perf_counter()

    def lap(label):
        print(f"[clock] {label} at {time.perf_counter() - t_start:.1f} s")

    if not torch.cuda.is_available():
        fail("no CUDA device: the port's kernels run only on an NVIDIA GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        import parallax_tpu_torch
    except ImportError:
        fail("parallax_tpu_torch not found: run from the root of a checkout")
    check(
        os.path.abspath(parallax_tpu_torch.__file__).startswith(here + os.sep),
        "parallax_tpu_torch must come from this checkout",
    )
    from parallax_tpu_torch.engine.batched import _to_soa, collide_batched
    from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
    from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
    from parallax_tpu_torch.ops import _build, contact_solver, fused_step
    from parallax_tpu_torch.parallel import rollout
    from parallax_tpu_torch.utils import prng
    from parallax_tpu_torch.utils.pytree import tree_map

    # the scenarios the card tests share (tests/torch_scenarios.py: torch and
    # numpy only)
    sys.path.insert(0, os.path.join(here, "tests"))
    from torch_scenarios import overlap_state, tie_fused_case, tie_solve_case

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    gpu = gpu_line()
    print(gpu)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    # -- phase 2: build --------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds if _build.build_seconds is not None else 0.0:.2f} s)")
    for src, lines in (_build.ptxas_report or {}).items():
        for line in lines:
            print(f"[ptxas] {src}: {line[:160]}")

    lap("phase 3 starts")
    # -- phase 3: kernels against their plain versions -------------------------
    env = LunarLander()
    cfg = env.world.config
    C, n, J = env.world.table.n_contacts, env.world.n_bodies, env.world.joints.n_joints
    st = lowered(env.reset_fn_batch(keys_for(B, 0, dev)), dev)
    st, _ = env.rollout_batch(st, zero_policy, 40)
    aux = env.plane_pack(st)
    override = {p: (aux.tox[i], aux.toy[i]) for i, p in enumerate(env._ground_parts)}
    s = _to_soa(st.bodies)
    con = collide_batched(env.world, s, override)
    n_active = int(con.active.sum())
    check(n_active > 100, f"scenario has {n_active} active lanes, need > 100")
    max_err = 0.0
    for pi in (cfg.position_iterations, 0):
        got = contact_solver.solve_contacts(env.world, s, con, cfg.solver_iterations,
                                            pi, cfg.dt, cfg.contact)
        want = contact_solver.solve_contacts_plain(env.world, s, con, cfg.solver_iterations,
                                                   pi, cfg.dt, cfg.contact)
        torch.cuda.synchronize()
        for f, a, b in zip(got._fields, got, want):
            err = (a - b).abs().max().item()
            check(np.isfinite(err) and err <= ATOL,
                  f"kernel vs plain: {f} differs by {err} (position_iterations={pi})")
            max_err = max(max_err, err)
    print(f"[kernel] contact_solve_fwd vs plain at B={B}: {n_active} active lanes, "
          f"max |diff| {max_err:.3e} <= {ATOL}")

    rng = np.random.default_rng(5)
    cot = type(s)(*(torch.from_numpy(rng.standard_normal((n, B)).astype(np.float32)).to(dev)
                    for _ in range(6)))
    solve_args = (cfg.solver_iterations, cfg.position_iterations, cfg.dt, cfg.contact)
    got = contact_solver.solve_contacts_bwd(env.world, s, con, cot, *solve_args)
    want = contact_solver.solve_contacts_bwd_plain(env.world, s, con, cot, *solve_args)
    torch.cuda.synchronize()
    bwd_err, _ = hold_vjp("contact_solve_bwd vs plain VJP", (*got[0], *got[1:]),
                          (*want[0], *want[1:]))
    print(f"[kernel] contact_solve_bwd vs plain VJP at B={B}: max |diff| {bwd_err:.3e} "
          f"(rtol {RTOL}, atol {ATOL})")

    def kernel_call():
        contact_solver.solve_contacts(env.world, s, con, *solve_args)

    def plain_call():
        contact_solver.solve_contacts_plain(env.world, s, con, *solve_args)

    def bwd_call():
        contact_solver.solve_contacts_bwd(env.world, s, con, cot, *solve_args)

    def bwd_plain_call():
        contact_solver.solve_contacts_bwd_plain(env.world, s, con, cot, *solve_args)

    kernel_ms, plain_ms, t = turns(kernel_call, plain_call, 20)
    print(f"[time] solve+joints per call at B={B}: kernel {kernel_ms:.4f} ms, "
          f"plain torch {plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}) on {gpu}")
    bwd_ms, bwd_plain_ms, t = turns(bwd_call, bwd_plain_call, 10)
    print(f"[time] reverse pass per call at B={B}: kernel {bwd_ms:.4f} ms, "
          f"plain autograd {bwd_plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}) on {gpu}")
    counts = (n_active, B, C, n, J, cfg.solver_iterations, cfg.position_iterations)
    fwd_bound, fwd_by = solver_bound_ms(*counts, bwd=False)
    bwd_bound, bwd_by = solver_bound_ms(*counts, bwd=True)
    print(f"[bound] at B={B}, {n_active} active lanes: forward {fwd_bound:.5f} ms "
          f"({fwd_by}), reverse pass {bwd_bound:.5f} ms ({bwd_by})")

    env_f = LunarLander(LanderConfig(broadphase=False, use_cuda_fused=True))
    got_s, got_c = fused_step.physics_core_fused(env_f.world, s, override)
    want_s, want_c = fused_step.fused_step_plain(env_f.world, s, override)
    torch.cuda.synchronize()
    f_active = int(want_c.active.sum())
    check(f_active > 100, f"fused scenario has {f_active} active lanes, need > 100")
    check(torch.equal(got_c.active, want_c.active),
          f"fused kernel vs plain: {int((got_c.active != want_c.active).sum())} active flags differ")
    fused_err = 0.0
    for f, a, b in zip(got_s._fields, got_s, want_s):
        err = (a - b).abs().max().item()
        check(np.isfinite(err) and err <= ATOL, f"fused kernel vs plain: {f} differs by {err}")
        fused_err = max(fused_err, err)
    print(f"[kernel] fused_step_fwd vs plain at B={B}: {f_active} active lanes, flags "
          f"identical, max |diff| {fused_err:.3e} <= {ATOL}")

    def fused_call():
        fused_step.physics_core_fused(env_f.world, s, override)

    def fused_plain_call():
        fused_step.fused_step_plain(env_f.world, s, override)

    fused_ms, fused_plain_ms, t = turns(fused_call, fused_plain_call, 20)
    print(f"[time] fused step per call at B={B}: kernel {fused_ms:.4f} ms, plain torch "
          f"{fused_plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}) on {gpu}")
    f_bound, f_by, f_bytes, f_ops = fused_bound_ms(env_f.world, sorted(override), f_active, B)
    print(f"[bound] fused step at B={B}, {f_active} active lanes: {f_bound:.5f} ms ({f_by}; "
          f"{f_bytes / 1e6:.2f} MB, {f_ops / 1e6:.1f} M float32 operations)")

    got = fused_step.fused_step_bwd(env_f.world, s, override, cot)
    want = fused_step.fused_step_bwd_plain(env_f.world, s, override, cot)
    torch.cuda.synchronize()
    fbwd_err, _ = hold_vjp("fused_step_bwd vs plain VJP", (*got[0], *got[1:]),
                           (*want[0], *want[1:]))
    check(all(x.abs().max().item() > 0 for x in got[0]), "fused reverse pass: a dead body plane")
    print(f"[kernel] fused_step_bwd vs plain VJP at B={B}: max |diff| {fbwd_err:.3e} "
          f"(rtol {RTOL}, atol {ATOL})")

    def fused_bwd_call():
        fused_step.fused_step_bwd(env_f.world, s, override, cot)

    def fused_bwd_plain_call():
        fused_step.fused_step_bwd_plain(env_f.world, s, override, cot)

    fbwd_ms, fbwd_plain_ms, t = turns(fused_bwd_call, fused_bwd_plain_call, 5)
    print(f"[time] fused reverse pass per call at B={B}: kernel {fbwd_ms:.4f} ms, plain "
          f"autograd {fbwd_plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}) on {gpu}")
    touched = touched_pairs(env_f.world, want_c.active)
    fb_bound, fb_by, fb_bytes, fb_ops = fused_bwd_bound_ms(
        env_f.world, sorted(override), f_active, touched, B)
    print(f"[bound] fused reverse pass at B={B}, {sum(touched)} pairs touching: "
          f"{fb_bound:.5f} ms ({fb_by}; {fb_bytes / 1e6:.2f} MB, {fb_ops / 1e6:.1f} M float32 "
          f"operations)")

    # the clamp-tie cases (tests/test_torch_clamp_ties.py) through both
    # reverse kernels against their plain VJPs
    ts, tcon, tcot = tie_solve_case(env, dev)
    got = contact_solver.solve_contacts_bwd(env.world, ts, tcon, tcot, *solve_args)
    want = contact_solver.solve_contacts_bwd_plain(env.world, ts, tcon, tcot, *solve_args)
    fs, fov, fcot = tie_fused_case(env_f, dev)
    fgot = fused_step.fused_step_bwd(env_f.world, fs, fov, fcot)
    fwant = fused_step.fused_step_bwd_plain(env_f.world, fs, fov, fcot)
    torch.cuda.synchronize()
    tie_errs = []
    for label, g_, w_ in (("contact_solve_bwd", got, want), ("fused_step_bwd", fgot, fwant)):
        err_max, _ = hold_vjp(f"{label} at a clamp tie", (*g_[0], *g_[1:]), (*w_[0], *w_[1:]))
        check(g_[0].vy.abs().max().item() > 0.1, f"{label} at a clamp tie: dead hull vy")
        tie_errs.append(err_max)
    bwd_err, fbwd_err = max(bwd_err, tie_errs[0]), max(fbwd_err, tie_errs[1])
    print(f"[kernel] clamp-tie cases (B=1, one lane at rest under the slop): contact_solve_bwd "
          f"max |diff| {tie_errs[0]:.3e}, fused_step_bwd max |diff| {tie_errs[1]:.3e} vs their "
          f"plain VJPs (rtol {RTOL}, atol {ATOL})")

    # the fused kernel's circle-circle and circle-box lanes: billiards8 with
    # its balls piled against the +x cushion
    env_b = Billiards(BilliardsConfig(use_cuda_fused=True))
    sb = overlap_state(env_b, B, 3, 1.0, 0.03, 0.02)
    got_s, got_c = fused_step.physics_core_fused(env_b.world, sb)
    want_s, want_c = fused_step.fused_step_plain(env_b.world, sb)
    torch.cuda.synchronize()
    check([g.kernel for g in env_b.world.table.groups] == ["cc", "cb"], "billiards8's groups")
    n_cc = env_b.world.table.groups[0].size
    cc_active, cb_active = int(want_c.active[:n_cc].sum()), int(want_c.active[n_cc:].sum())
    check(cc_active > 0 and cb_active > 0, f"billiards8 scenario: {cc_active} cc and "
          f"{cb_active} cb lanes active, need both > 0")
    check(torch.equal(got_c.active, want_c.active),
          f"fused cc/cb lanes vs plain: {int((got_c.active != want_c.active).sum())} flags differ")
    b_err = 0.0
    for f, a, b in zip(got_s._fields, got_s, want_s):
        err = (a - b).abs().max().item()
        check(np.isfinite(err) and err <= ATOL, f"fused cc/cb lanes vs plain: {f} differs by {err}")
        b_err = max(b_err, err)
    print(f"[kernel] fused_step_fwd (cc, cb lanes) vs plain on billiards8 at B={B}: {cc_active} cc "
          f"and {cb_active} cb lanes active, flags identical, max |diff| {b_err:.3e} <= {ATOL}")
    fused_err = max(fused_err, b_err)

    def b_call():
        fused_step.physics_core_fused(env_b.world, sb)

    def b_plain_call():
        fused_step.fused_step_plain(env_b.world, sb)

    b_ms, b_plain_ms, t = turns(b_call, b_plain_call, 20)
    print(f"[time] fused step per call on billiards8 at B={B}: kernel {b_ms:.4f} ms, plain "
          f"torch {b_plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}) on {gpu}")
    b_bound, b_by, b_bytes, b_ops = fused_bound_ms(env_b.world, [], cc_active + cb_active, B)
    print(f"[bound] fused step on billiards8 at B={B}, {cc_active + cb_active} active lanes: "
          f"{b_bound:.5f} ms ({b_by}; {b_bytes / 1e6:.2f} MB, {b_ops / 1e6:.1f} M float32 "
          f"operations)")

    solves = circle_solves(gpu)
    max_err = max([max_err] + [v["max_abs_err"] for v in solves.values()])
    lap("phase 3 on RoboCup starts")
    rc = robocup_kernels(env_b, gpu)

    lap("phase 4 starts")
    # -- phase 4: the rollout path ---------------------------------------------------
    params = policy_params(dev)
    states = env.reset_fn_batch(keys_for(B, 1, dev))
    torch.cuda.synchronize()
    contact_solver.launches = 0
    contact_solver.bwd_launches = 0
    t0 = time.perf_counter()
    final, traj = env.rollout_batch(states, policy, STEPS, params)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = contact_solver.launches
    check(launches == STEPS, f"kernel launched {launches} times in {STEPS} steps")
    check(contact_solver.bwd_launches == 0, "a forward rollout launched the reverse pass")
    check(torch.isfinite(traj.obs).all().item(), "non-finite obs")
    check(torch.isfinite(traj.reward).all().item(), "non-finite reward")
    check(tuple(traj.obs.shape) == (STEPS, B, 9), f"obs shape {tuple(traj.obs.shape)}")
    print(f"[main] rollout_batch B={B} x {STEPS} steps: kernel launches {launches}, "
          f"obs/reward finite, {main_s:.2f} s wall")

    st = lowered(env.reset_fn_batch(keys_for(B, 2, dev)), dev)
    _, traj2 = env.rollout_batch(st, zero_policy, 100)
    legs = int(traj2.info["leg_contacts"].sum())
    terms = int(traj2.terminated.sum())
    check(legs > 0 and terms > 0, f"lowered rollout: {legs} leg contacts, {terms} terminations")
    print(f"[main] lowered start B={B} x 100 steps: {legs} leg-contact flags, "
          f"{terms} terminations")

    env_cpu = LunarLander(device="cpu")
    small = {}
    for d, e in (("cuda", env), ("cpu", env_cpu)):
        st = lowered(e.reset_fn_batch(keys_for(SMALL_B, 4, d)), d)
        _, tr = e.rollout_batch(st, policy, SMALL_STEPS, policy_params(d))
        small[d] = tr
    g, c = small["cuda"], small["cpu"]
    obs_err = (g.obs.cpu() - c.obs).abs().max().item()
    rew_err = (g.reward.cpu() - c.reward).abs().max().item()
    done_share = (g.done.cpu() == c.done).all(0).double().mean().item()
    print(f"[check] B={SMALL_B} x {SMALL_STEPS} steps, card vs CPU: max |obs diff| "
          f"{obs_err:.3e}, max |reward diff| {rew_err:.3e}, worlds with equal done "
          f"sequences {done_share:.4f}")
    check(obs_err <= CPU_ATOL and rew_err <= CPU_ATOL,
          f"card vs CPU rollout differ beyond {CPU_ATOL}")
    check(done_share >= CPU_DONE_SHARE, f"done sequences agree in {done_share} of worlds")

    # the fused path: a lowered start, so legs and hull touch down
    st = lowered(env_f.reset_fn_batch(keys_for(B, 2, dev)), dev)
    torch.cuda.synchronize()
    fused_step.launches = 0
    contact_solver.launches = 0
    t0 = time.perf_counter()
    _, traj_f = env_f.rollout_batch(st, policy, STEPS, params)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    fused_launches, f_solver = fused_step.launches, contact_solver.launches
    check(fused_launches == STEPS, f"fused kernel launched {fused_launches} times in {STEPS} steps")
    check(f_solver == 0, f"the fused rollout launched the solver kernel {f_solver} times")
    check(torch.isfinite(traj_f.obs).all().item(), "fused rollout: non-finite obs")
    check(torch.isfinite(traj_f.reward).all().item(), "fused rollout: non-finite reward")
    f_legs = int(traj_f.info["leg_contacts"].sum())
    f_terms = int(traj_f.terminated.sum())
    check(f_legs > 0 and f_terms > 0, f"fused rollout: {f_legs} leg contacts, {f_terms} terminations")
    print(f"[main] fused rollout_batch B={B} x {STEPS} steps (lowered start): fused launches "
          f"{fused_launches}, solver launches {f_solver}, obs/reward finite, {f_legs} "
          f"leg-contact flags, {f_terms} terminations, {fused_s:.2f} s wall")

    env_f_cpu = LunarLander(LanderConfig(broadphase=False, use_cuda_fused=True), device="cpu")
    small = {}
    for d, e in (("cuda", env_f), ("cpu", env_f_cpu)):
        st = lowered(e.reset_fn_batch(keys_for(SMALL_B, 4, d)), d)
        _, tr = e.rollout_batch(st, policy, SMALL_STEPS, policy_params(d))
        small[d] = tr
    g, c = small["cuda"], small["cpu"]
    obs_err = (g.obs.cpu() - c.obs).abs().max().item()
    rew_err = (g.reward.cpu() - c.reward).abs().max().item()
    done_share = (g.done.cpu() == c.done).all(0).double().mean().item()
    print(f"[check] fused B={SMALL_B} x {SMALL_STEPS} steps, card vs CPU: max |obs diff| "
          f"{obs_err:.3e}, max |reward diff| {rew_err:.3e}, worlds with equal done "
          f"sequences {done_share:.4f}")
    check(obs_err <= CPU_ATOL and rew_err <= CPU_ATOL,
          f"fused: card vs CPU rollout differ beyond {CPU_ATOL}")
    check(done_share >= CPU_DONE_SHARE, f"fused: done sequences agree in {done_share} of worlds")

    lap("phase 5 starts")
    # -- phase 5: times of the rollout --------------------------------------------------
    steps = 30
    states = env.reset_fn_batch(keys_for(B, 5, dev))
    rates = {"split": [], "fused": []}
    for label in ("split", "fused", "fused", "split"):
        e = env if label == "split" else env_f
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.rollout_batch(states, policy, steps, params)
        torch.cuda.synchronize()
        rates[label].append(B * steps / (time.perf_counter() - t0))
    rate, fused_rate = max(rates["split"]), max(rates["fused"])
    print(f"[time] LunarLander rollout B={B}: split {rate:.1f}, fused {fused_rate:.1f} "
          f"env-steps/s (best of 2 turns each of {steps} chained steps, one sync; turns "
          f"split {[round(x, 1) for x in rates['split']]}, fused "
          f"{[round(x, 1) for x in rates['fused']]}) on {gpu}")

    ps = env._to_planes(states)
    acts = torch.zeros((B, 2), device=dev)
    s1 = env.plane_pre(ps.s, ps.aux, acts)
    ov = {p: (ps.aux.tox[i], ps.aux.toy[i]) for i, p in enumerate(env._ground_parts)}
    layers = {
        "step (_step_planes)": lambda: env._step_planes(ps, acts),
        "collide_batched": lambda: collide_batched(env.world, s1, ov),
        "plane_fresh (threefry terrain)": lambda: env.plane_fresh(prng.split(ps.key)[:, 0]),
        "solve+joints kernel": kernel_call,
        "fused step (one step of the fused world)": lambda: env_f._step_planes(ps, acts),
        "fused step kernel": fused_call,
    }
    for label, fn in layers.items():
        cuda_ms(fn, 3)
        print(f"[time] {label}: {cuda_ms(fn, 10):.4f} ms per call at B={B} on {gpu}")

    lap("phase 5b starts")
    # -- phase 5b: the circle worlds' paths -----------------------------------------
    circle = circle_worlds(env_b, gpu)

    lap("phase 5b on RoboCup starts")
    rc_paths = robocup_paths(gpu)

    lap("phase 6 starts")
    # -- phase 6: the train path, card against CPU ----------------------------------
    # the contact state, made on the card; both runs start from it
    st = lowered(env.reset_fn_batch(keys_for(SMALL_B, 6, dev)), dev)
    st, _ = env.rollout_batch(st, zero_policy, 40)
    cpu_st = tree_map(lambda x: x.cpu(), st)
    res = {}
    for d, e in (("cuda", env), ("cpu", env_cpu)):
        st = tree_map(lambda x: x.to(d), cpu_st)
        p = mlp_params(d)
        loss, _ = rollout.make_loss_fn(e, mlp, SMALL_H, checkpoint_segments=2)(p, st)
        res[d] = (loss.item(), [x.cpu() for x in torch.autograd.grad(loss, list(p.values()))])
    (loss_g, grads_g), (loss_c, grads_c) = res["cuda"], res["cpu"]
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    grad_rel = max((a - b).norm().item() / b.norm().item() for a, b in zip(grads_g, grads_c))
    print(f"[check] train loss+grads B={SMALL_B} h={SMALL_H} from the contact state, card vs "
          f"CPU: loss {loss_g:.7f} vs {loss_c:.7f} (rel {loss_rel:.2e}), policy grads max "
          f"rel diff in norm {grad_rel:.2e}")
    check(loss_rel <= LOSS_RTOL, f"train loss: card vs CPU rel diff {loss_rel}")
    check(grad_rel <= GRAD_RTOL, f"policy grads: card vs CPU rel diff {grad_rel}")
    check(all(g.norm().item() > 0 for g in grads_g), "a policy gradient is zero")

    # the fused train path on the card against the same CPU run: on the CPU
    # the fused step's train path equals the split one to the bit
    # (tests/test_torch_fused_step.py), so the split CPU run is its reference
    st = tree_map(lambda x: x.to(dev), cpu_st)
    p = mlp_params(dev)
    loss, _ = rollout.make_loss_fn(env_f, mlp, SMALL_H, checkpoint_segments=2)(p, st)
    loss_f, grads_f = loss.item(), [x.cpu() for x in torch.autograd.grad(loss, list(p.values()))]
    floss_rel = abs(loss_f - loss_c) / abs(loss_c)
    fgrad_rel = max((a - b).norm().item() / b.norm().item() for a, b in zip(grads_f, grads_c))
    print(f"[check] fused train loss+grads B={SMALL_B} h={SMALL_H} from the contact state, card "
          f"vs CPU: loss {loss_f:.7f} vs {loss_c:.7f} (rel {floss_rel:.2e}), policy grads max "
          f"rel diff in norm {fgrad_rel:.2e}")
    check(floss_rel <= LOSS_RTOL, f"fused train loss: card vs CPU rel diff {floss_rel}")
    check(fgrad_rel <= GRAD_RTOL, f"fused policy grads: card vs CPU rel diff {fgrad_rel}")
    check(all(g.norm().item() > 0 for g in grads_f), "a fused policy gradient is zero")
    lap("phases 4 and 6 on RoboCup and billiards8 start")
    robocup_card_vs_cpu(env_b)

    lap("phase 7 starts")
    # -- phase 7: the train path at full width, split and fused -------------------------
    runs = {}
    for label, e in (("split", env), ("fused", env_f)):
        params = mlp_params(dev)
        step = rollout.make_train_step(e, mlp, rollout.adam(params, 3e-3), HORIZON,
                                       checkpoint_segments=SEGMENTS)
        states = e.reset_fn_batch(keys_for(B, 7, dev))
        params, states, m = step(params, states)  # warm-up
        check(np.isfinite(m["loss"].item()), f"{label} warm-up train step: non-finite loss")
        runs[label] = (e, step, params, states)
    lap("train warm-ups done")
    # one timed step each, in turns; each counts its launches from zero
    want_counts = {"split": (2 * HORIZON, HORIZON, 0, 0), "fused": (0, 0, 2 * HORIZON, HORIZON)}
    train = {}
    for label in ("split", "fused"):
        e, step, params, states = runs[label]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        contact_solver.launches = contact_solver.bwd_launches = 0
        fused_step.launches = fused_step.bwd_launches = 0
        t0 = time.perf_counter()
        params, states, m = step(params, states)
        loss = m["loss"].item()  # synchronizes
        sec = time.perf_counter() - t0
        counts = (contact_solver.launches, contact_solver.bwd_launches,
                  fused_step.launches, fused_step.bwd_launches)
        check(np.isfinite(loss), f"{label} train step: non-finite loss {loss}")
        check(counts == want_counts[label],
              f"{label} train step: launches (solver fwd, bwd, fused fwd, bwd) {counts}, "
              f"want {want_counts[label]}")
        check(all(torch.isfinite(p).all().item() for p in params.values()),
              f"{label} train step: non-finite params")
        peak = torch.cuda.max_memory_allocated() / 2**30
        train[label] = (sec, counts)
        runs[label] = (e, step, params, states)
        print(f"[train] {label} step B={B} h={HORIZON} segments={SEGMENTS}: loss {loss:.6f}, "
              f"{sec:.3f} s, launches solver fwd {counts[0]} bwd {counts[1]}, fused fwd "
              f"{counts[2]} bwd {counts[3]}, peak memory {peak:.2f} GiB")
    print(f"[time] lunarlander_train_env_steps_per_sec_per_chip_batch{B}_h{HORIZON}: split "
          f"{B * HORIZON / train['split'][0]:.1f}, fused {B * HORIZON / train['fused'][0]:.1f} "
          f"env-steps/s (one timed train step each after a warm-up, in turns) on {gpu}")

    # where a train step's time goes: the forward under autograd, then the
    # backward (each segment's recompute and its reverse passes)
    lap("train steps done")
    for label, (e, _, params, states) in runs.items():
        profile_train(label, rollout.make_loss_fn(e, mlp, PROFILE_H, 2), params, states, gpu)
    del runs
    lap("phase 7 on RoboCup and billiards8 starts")
    rc_train = robocup_train(env_b, gpu)
    lap("done")
    print(json.dumps({"kernels": [
        {
            "name": "contact_solve_fwd",
            "route": "cuda",
            "source": "parallax_tpu_torch/csrc/contact_solver.cu",
            "replaces": "parallax_tpu/ops/pallas_solver.py:581",
            # the lander's rollout and the circle worlds' split rollouts
            "launches": launches + sum(circle[f"{k} split"][1][0] for k in solves)
            + rc_paths["robocup split"][1][0],
            "max_abs_err": max_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": fwd_bound,
            "bound_by": fwd_by,
            "library_ms": None,
            **{k: {"launches": circle[f"{k} split"][1][0], **v} for k, v in solves.items()},
            "robocup": {"launches": rc_paths["robocup split"][1][0], **rc["solve"]},
        },
        {
            "name": "contact_solve_bwd",
            "route": "cuda",
            "source": "parallax_tpu_torch/csrc/contact_solver_bwd.cu",
            "replaces": "parallax_tpu/ops/pallas_solver.py:534",
            # the lander's and RoboCup's split train steps
            "launches": train["split"][1][1] + rc_train["robocup split"][1][1],
            "max_abs_err": max(bwd_err, rc["solve_bwd"]["max_abs_err"]),
            "ms": bwd_ms,
            "plain_ms": bwd_plain_ms,
            "bound_ms": bwd_bound,
            "bound_by": bwd_by,
            "library_ms": None,
            "robocup": {"launches": rc_train["robocup split"][1][1], **rc["solve_bwd"]},
        },
        {
            "name": "fused_step_fwd",
            "route": "cuda",
            "source": "parallax_tpu_torch/csrc/fused_step.cu",
            "replaces": "parallax_tpu/ops/pallas_step.py:473",
            "lanes": ["pp", "cc", "cb", "area_cb"],
            # the lander's fused rollout (pp), billiards8's (cc, cb) and
            # RoboCup's (cc, cb, area_cb)
            "launches": fused_launches + circle["billiards8 fused"][1][1]
            + rc_paths["robocup fused"][1][1],
            "max_abs_err": max(fused_err, rc["fwd"]["max_abs_err"]),
            "ms": fused_ms,
            "plain_ms": fused_plain_ms,
            "bound_ms": f_bound,
            "bound_by": f_by,
            "library_ms": None,
            "billiards8": {
                "launches": circle["billiards8 fused"][1][1],
                "max_abs_err": b_err,
                "ms": b_ms,
                "plain_ms": b_plain_ms,
                "bound_ms": b_bound,
                "bound_by": b_by,
            },
            "robocup": {"launches": rc_paths["robocup fused"][1][1],
                        **{k: v for k, v in rc["fwd"].items() if k != "active"}},
        },
        {
            "name": "fused_step_bwd",
            "route": "cuda",
            "source": "parallax_tpu_torch/csrc/fused_step_bwd.cu",
            "replaces": "parallax_tpu/ops/pallas_step.py:495",
            "lanes": ["pp", "cc", "cb", "area_cb"],
            # the fused train steps of the lander and RoboCup, and billiards8's cue objective
            "launches": train["fused"][1][3] + rc_train["robocup fused"][1][3]
            + rc_train["billiards8 fused cue objective"][1][3],
            "max_abs_err": max(fbwd_err, rc["bwd"]["max_abs_err"],
                               rc["bwd_billiards8"]["max_abs_err"]),
            "ms": fbwd_ms,
            "plain_ms": fbwd_plain_ms,
            "bound_ms": fb_bound,
            "bound_by": fb_by,
            "library_ms": None,
            "robocup": {"launches": rc_train["robocup fused"][1][3], **rc["bwd"]},
            "billiards8": {"launches": rc_train["billiards8 fused cue objective"][1][3], **rc["bwd_billiards8"]},
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
