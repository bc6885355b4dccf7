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
  (``cue_loss_fn``: billiards' own reward has no gradient path);
* ``engine.batched.step_batched`` on user-built worlds: the crate pile
  (``tests/torch_scenarios.py:crate_world``: a floor, two walls, 8 crates,
  3 balls, 88 one-lane pairs) at B=8192, 100 steps on the split step (the
  solve kernel) and on the fused step (its bb lanes, no solver launch),
  and the gradient of ``crate_kick_loss`` through 100 steps (the reverse
  kernels); and the JAX tests' mixed and area worlds on the split step.

* the fleet (phase 8, ``parallel/mesh.py``): a one-rank NCCL world mesh
  at B=8192 and ``max_chunk=4096`` (two waves), the lander's
  ``rollout_batch(mesh=)``, its split and fused train steps (one gradient
  all-reduce) bitwise equal to the calls without a mesh, with the
  kernels' launches and the collectives counted; two gloo ranks on the
  card, each with half of the same 8,192 worlds, against the one-process
  train step; ``parallel/dryrun.py:dryrun_multichip`` on the mesh.

* the options (phase 9): ``LanderConfig(terrain_candidates=True)`` at
  B=8192, split and fused, step by step against the full-table lander,
  its rollouts timed in turns with the full table's, the four kernels on
  its contact scenario against their plain versions and its train steps
  card against CPU; ``BilliardsConfig(rolled=True)`` (``engine/rolled.py``,
  no kernel) with 7 and 47 object balls beside the lane engine and card
  against CPU; the lander's split train step with and without
  ``PARALLAX_REMAT_COLLIDE`` (set in a process of its own).

All four kernels run one warp per world, several worlds a block
(``contact_solver.WORLDS_PER_BLOCK``); phase 3 holds each to the bit
across two launches and across plans of 2, 4 and 8 worlds a block, times
each plan on the crate pile, and holds them to their plain versions on a
ragged batch (B - 1 worlds) and, for the solver's two, on billiards48 (52
bodies, more than a warp's threads; 1,320 lanes).

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
    every circle or box pair its lane (``LANE_OPS``), every rotated
    vertex 8, every body 8 to integrate and about 40 for its cosine and
    sine, and the solve and joints as ``solver_bound_ms`` counts them for
    the run's active lanes."""
    from parallax_tpu_torch.ops.fused_step import fused_operands

    ops_ = fused_operands(world)
    parts = ops_.part_i.tolist()
    per_world = 0
    for _, _, va, vb, _, _, _, kind in ops_.pair_i.tolist():
        per_world += pair_ops(va, vb, kind)
    per_world += sum(8 * nv for p, (_, _, nv, _) in enumerate(parts) if p not in override_parts)
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
    edge normal; for a circle or box pair its lane and ``LANE_BWD_OPS``."""
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


# float32 operations of one circle-circle, circle-box, circle-in-area and
# box-box lane (pair kinds 1, 2, 3, 4), counted from fused_step.cuh's CcLane,
# CbLane, AreaCbLane and BbLane, and of their adjoints in fused_step_bwd.cu
LANE_OPS = {1: 45, 2: 60, 3: 35, 4: 30}
LANE_BWD_OPS = {1: 45, 2: 50, 3: 20, 4: 50}


def pair_ops(va, vb, kind=0):
    """float32 operations of one pair's lanes (see fused_bound_ms): a
    polygon pair's SAT and clip (kind 0), or a circle or box pair's
    analytic lane (kind 1: cc, 2: cb, 3: area_cb, 4: bb)."""
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
        ("billiards48 fused", Billiards(BilliardsConfig(n_object=47, use_cuda_fused=True)),
         "fused"),
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
        err = planes_err(f"solve kernel vs plain on {label}", got, want)
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


def planes_err(label, got, want, bar=ATOL):
    """The largest difference over the planes of two ``_SoA``s (or tuples of
    planes); fail on a non-finite value or beyond ``bar``."""
    err = 0.0
    for f, a, b in zip(getattr(got, "_fields", range(len(got))), got, want):
        d = (a - b).abs().max().item()
        check(np.isfinite(d) and d <= bar, f"{label}: {f} differs by {d}")
        err = max(err, d)
    return err


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
    err = planes_err("fused kernel vs plain on RoboCup", got_s, want_s)
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
    err = planes_err("solve kernel vs plain on RoboCup", got, want)
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


def crate_kernels(gpu):
    """Phase 3 on the crate pile (14 bodies, C=88 one-lane pairs: 3 cc, 33
    cb, 52 bb) at B: the fused kernel (its bb lanes with cc and cb) and its
    reverse pass against their plain versions on ``crate_overlap_state``
    and at ``bb_tie_case`` (B=1); the solve kernel and its reverse pass at
    the pile's split shapes and at the mixed world's (2-lane pp and bp
    manifolds with partners, one-lane cp, cc and cb).  Returns ``{entry:
    results}``."""
    from parallax_tpu_torch.engine.batched import collide_batched, integrate_bm
    from parallax_tpu_torch.ops import contact_solver, fused_step
    from torch_scenarios import (active_kinds, bb_tie_case, cotangents, crate_overlap_state,
                                 crate_world, kinds_state, kinds_world)

    dev = torch.device("cuda")
    out = {}
    w, _ = crate_world("cuda", fused=True)
    s = crate_overlap_state(w, B)
    got_s, got_c = fused_step.physics_core_fused(w, s)
    want_s, want_c = fused_step.fused_step_plain(w, s)
    torch.cuda.synchronize()
    kinds = active_kinds(w, want_c.active)
    check(set(kinds) == {"cc", "cb", "bb"} and min(kinds.values()) > 0,
          f"crate scenario: active lanes {kinds}")
    check(torch.equal(got_c.active, want_c.active),
          f"fused bb lanes vs plain on the crate pile: "
          f"{int((got_c.active != want_c.active).sum())} flags differ")
    err = planes_err("fused kernel vs plain on the crate pile", got_s, want_s)
    ms, plain_ms, t = turns(lambda: fused_step.physics_core_fused(w, s),
                            lambda: fused_step.fused_step_plain(w, s), 20)
    n_act = sum(kinds.values())
    bound, by, nbytes, ops = fused_bound_ms(w, [], n_act, B)
    print(f"[kernel] fused_step_fwd (bb, cb, cc lanes) vs plain on the crate pile at B={B}: active "
          f"lanes {kinds}, flags identical, max |diff| {err:.3e} <= {ATOL}")
    print(f"[time] fused step per call on the crate pile at B={B}: kernel {ms:.4f} ms, plain torch "
          f"{plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}) on {gpu}")
    print(f"[bound] fused step on the crate pile at B={B}, {n_act} active lanes: {bound:.5f} ms "
          f"({by}; {nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M float32 operations)")
    out["fwd"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                  "bound_by": by}

    cot = cotangents(w.n_bodies, B, 5, dev)
    got = fused_step.fused_step_bwd(w, s, None, cot)[0]
    want = fused_step.fused_step_bwd_plain(w, s, None, cot)[0]
    torch.cuda.synchronize()
    err, share = hold_vjp("fused_step_bwd on the crate pile", got, want)
    off = float64_reading(got, want, fused_vjp64(w, s, cot))
    check(all(x.abs().max().item() > 0 for x in got[:4]), "fused reverse pass on the crate "
          "pile: a dead plane")
    print(f"[kernel] fused_step_bwd (bb, cb, cc lanes) vs plain VJP on the crate pile at B={B}: max "
          f"|diff| {err:.3e}, {share:.3f} of the bar (rtol {RTOL}, atol {ATOL}); worlds off the "
          f"float64 VJP by more than 1e-3: kernel {off[0]}, plain float32 {off[1]}")
    ms, plain_ms, t = turns(lambda: fused_step.fused_step_bwd(w, s, None, cot),
                            lambda: fused_step.fused_step_bwd_plain(w, s, None, cot), 5)
    touched = touched_pairs(w, want_c.active)
    bound, by, nbytes, ops = fused_bwd_bound_ms(w, [], n_act, touched, B)
    print(f"[time] fused reverse pass per call on the crate pile at B={B}: kernel {ms:.4f} ms, plain "
          f"autograd {plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}) on {gpu}")
    print(f"[bound] fused reverse pass on the crate pile at B={B}, {sum(touched)} pairs touching: "
          f"{bound:.5f} ms ({by}; {nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M float32 operations)")
    out["bwd"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                  "bound_by": by}

    # the bb lane's exact ties (B=1): the aligned stack's contact point and
    # the corner overlap's nested minimum
    ts, tcot = bb_tie_case(w, dev)
    got_s, got_c = fused_step.physics_core_fused(w, ts)
    want_s, want_c = fused_step.fused_step_plain(w, ts)
    got = fused_step.fused_step_bwd(w, ts, None, tcot)[0]
    want = fused_step.fused_step_bwd_plain(w, ts, None, tcot)[0]
    torch.cuda.synchronize()
    check(active_kinds(w, want_c.active) == {"cc": 0, "cb": 0, "bb": 2}, "bb_tie_case's lanes")
    check(torch.equal(got_c.active, want_c.active), "bb_tie_case: flags differ")
    tie_f = planes_err("fused kernel vs plain at bb_tie_case", got_s, want_s)
    tie_b, tie_share = hold_vjp("fused_step_bwd at bb_tie_case", got, want)
    check(got.py.abs().max().item() > 0.01, "bb_tie_case: a dead plane")
    print(f"[kernel] bb_tie_case (B=1: two crates stacked and aligned, two squares overlapping a "
          f"corner equally in x and y): fused_step_fwd max |diff| {tie_f:.3e}, fused_step_bwd max "
          f"|diff| {tie_b:.3e} ({tie_share:.3f} of the bar) vs the plain versions")
    out["fwd"]["max_abs_err"] = max(out["fwd"]["max_abs_err"], tie_f)
    out["bwd"]["max_abs_err"] = max(out["bwd"]["max_abs_err"], tie_b)

    # rows 1 and 2 at the pile's split shapes and at the mixed world's
    ws, _ = crate_world("cuda")
    wm, st0 = kinds_world("mixed", "cuda", use_cuda_solver=True)
    for label, world, sw, barred in (
            ("crates", ws, s, True),
            # the JAX test's perturbations of the mixed world, no pile: the
            # reverse pass there is a reading (random drops and tumbles put
            # lanes at kinks, where two float32 VJPs differ by O(1))
            ("mixed", wm, kinds_state("mixed", wm, st0, B, pile=False), False)):
        c = world.config
        si, _ = integrate_bm(world, sw)
        con = collide_batched(world, si)
        args = (c.solver_iterations, c.position_iterations, c.dt, c.contact)
        got = contact_solver.solve_contacts(world, si, con, *args)
        want = contact_solver.solve_contacts_plain(world, si, con, *args)
        torch.cuda.synchronize()
        err = planes_err(f"solve kernel vs plain on the {label} world", got, want)
        cot = cotangents(world.n_bodies, B, 5, dev)
        got = contact_solver.solve_contacts_bwd(world, si, con, cot, *args)
        want = contact_solver.solve_contacts_bwd_plain(world, si, con, cot, *args)
        torch.cuda.synchronize()
        berr, bshare = hold_vjp(f"contact_solve_bwd on the {label} world", (*got[0], *got[1:]),
                                (*want[0], *want[1:]), barred)

        def d64(x):
            return x.double() if x.is_floating_point() else x

        want64 = contact_solver.solve_contacts_bwd_plain(
            world, type(si)(*map(d64, si)), type(con)(*map(d64, con)),
            type(cot)(*map(d64, cot)), *args)
        off = float64_reading((*got[0], *got[1:]), (*want[0], *want[1:]),
                              (*want64[0], *want64[1:]))
        n_act = int(con.active.sum())
        C, n = world.table.n_contacts, world.n_bodies
        kinds = active_kinds(world, con.active)
        print(f"[kernel] contact_solve_fwd vs plain on the {label} world at B={B} ({n} bodies, "
              f"C={C}, active {kinds}): max |diff| {err:.3e} <= {ATOL}; contact_solve_bwd vs plain "
              f"VJP: max |diff| {berr:.3e}, {bshare:.3f} of the bar"
              f"{'' if barred else ' (a reading, no bar)'}; worlds off the float64 VJP by more "
              f"than 1e-3: kernel {off[0]}, plain float32 {off[1]}")
        entry = {}
        for key, e_, fn, plain, reps in (
                ("solve", err, lambda: contact_solver.solve_contacts(world, si, con, *args),
                 lambda: contact_solver.solve_contacts_plain(world, si, con, *args), 10),
                ("solve_bwd", berr,
                 lambda: contact_solver.solve_contacts_bwd(world, si, con, cot, *args),
                 lambda: contact_solver.solve_contacts_bwd_plain(world, si, con, cot, *args), 5)):
            ms, plain_ms, t = turns(fn, plain, reps)
            bound, by = solver_bound_ms(n_act, B, C, n, 0, c.solver_iterations,
                                        c.position_iterations, bwd=key == "solve_bwd")
            print(f"[time] contact_{key} per call on the {label} world at B={B}: kernel {ms:.4f} "
                  f"ms, plain {plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}); bound "
                  f"{bound:.5f} ms ({by}) on {gpu}")
            entry[key] = {"max_abs_err": e_, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                          "bound_by": by}
        out[label] = entry
    return out


PLANS = (2, 4, 8)  # worlds a block the four kernels are timed at
B48 = 256  # billiards48's batch in phase 3


def hold_fwd(label, got, want):
    """``planes_err`` of a forward kernel's body planes against its plain
    version's, where both may end with the fused step's flags, which must
    be identical."""
    if got[-1].dtype == torch.bool:
        check(torch.equal(got[-1], want[-1]),
              f"{label}: {int((got[-1] != want[-1]).sum())} active flags differ")
        got, want = got[:-1], want[:-1]
    return planes_err(label, got, want)


def launch_plans(gpu):
    """Phase 3 for the four kernels' launch plan (one warp per world,
    ``contact_solver.WORLDS_PER_BLOCK`` worlds a block): on the crate pile
    at B, two launches on the same inputs equal to the bit, and each plan of
    PLANS giving the same bits, timed in turns; at B - 1 worlds (a ragged
    last block) the forwards against their plain versions (body planes
    within ATOL, flags identical) and the reverse passes against their
    plain VJPs at the bar; and on billiards48 at B48 (52 bodies, more than a
    warp's threads, and C=1320 lanes, whose solve keeps its lane fields in
    scratch): the solve against its plain version on its pairs state and
    its overlap pile, and the solver reverse pass on its pairs state at the
    bar and on its pile (lanes at kinks, where two float32 VJPs differ) as
    a float64 reading.  Returns ``{kernel: results}``."""
    from parallax_tpu_torch.engine.batched import collide_batched, integrate_bm
    from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
    from parallax_tpu_torch.ops import _build, contact_solver, fused_step
    from torch_scenarios import (billiards_pairs_state, cotangents, crate_overlap_state,
                                 crate_world, overlap_state)

    dev = torch.device("cuda")
    wf, _ = crate_world("cuda", fused=True)
    ws, _ = crate_world("cuda")
    c = ws.config
    args = (c.solver_iterations, c.position_iterations, c.dt, c.contact)

    def calls(batch):
        s = crate_overlap_state(wf, batch)
        cot = cotangents(wf.n_bodies, batch, 5, dev)
        si, _ = integrate_bm(ws, s)
        con = collide_batched(ws, si)

        def solve_fwd(solve=contact_solver.solve_contacts):
            return tuple(solve(ws, si, con, *args))

        def fused_fwd(step=fused_step.physics_core_fused):
            out, con_ = step(wf, s)
            return (*out, con_.active)

        def solve():
            g = contact_solver.solve_contacts_bwd(ws, si, con, cot, *args)
            return (*g[0], *g[1:])

        def solve_plain():
            g = contact_solver.solve_contacts_bwd_plain(ws, si, con, cot, *args)
            return (*g[0], *g[1:])

        def fused():
            g = fused_step.fused_step_bwd(wf, s, None, cot)
            return (*g[0], *g[1:])

        def fused_plain():
            g = fused_step.fused_step_bwd_plain(wf, s, None, cot)
            return (*g[0], *g[1:])

        return {
            "contact_solve_fwd": (solve_fwd,
                                  lambda: solve_fwd(contact_solver.solve_contacts_plain)),
            "fused_step_fwd": (fused_fwd, lambda: fused_fwd(fused_step.fused_step_plain)),
            "contact_solve_bwd": (solve, solve_plain),
            "fused_step_bwd": (fused, fused_plain),
        }

    out = {}
    default = contact_solver.WORLDS_PER_BLOCK
    for name, (fn, _) in calls(B).items():
        first, again = fn(), fn()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"{name}: two launches on the same inputs differ")
        plans = {}
        for w in PLANS:
            contact_solver.WORLDS_PER_BLOCK = w
            got = fn()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(first, got)),
                  f"{name}: {w} worlds a block change the bits")
            cuda_ms(fn, 2)
            plans[w] = min(cuda_ms(fn, 5) for _ in range(2))
        contact_solver.WORLDS_PER_BLOCK = default
        print(f"[kernel] {name} on the crate pile at B={B}: two launches equal to the bit, and "
              f"so are the plans of {list(PLANS)} worlds a block (default {default})")
        print(f"[time] {name} per call on the crate pile at B={B} by worlds a block: "
              + ", ".join(f"{w}: {ms:.4f} ms" for w, ms in plans.items()) + f" on {gpu}")
        out[name] = {"worlds_per_block": default, "plans_ms": plans}
        del first, again, got
    for name, (fn, plain) in calls(B - 1).items():
        got, want = fn(), plain()
        torch.cuda.synchronize()
        if name.endswith("_fwd"):
            err = hold_fwd(f"{name} at B={B - 1}", got, want)
            print(f"[kernel] {name} vs plain on the crate pile at B={B - 1} (a ragged last "
                  f"block): max |diff| {err:.3e} <= {ATOL}"
                  + (", flags identical" if name == "fused_step_fwd" else ""))
        else:
            err, share = hold_vjp(f"{name} at B={B - 1}", got, want)
            print(f"[kernel] {name} vs plain VJP on the crate pile at B={B - 1} (a ragged last "
                  f"block): max |diff| {err:.3e}, {share:.3f} of the bar")
        out[name]["ragged_max_abs_err"] = err

    env = Billiards(BilliardsConfig(n_object=47))
    w, c = env.world, env.world.config
    b_args = (c.solver_iterations, c.position_iterations, c.dt, c.contact)
    cot = cotangents(w.n_bodies, B48, 5, dev)
    in_smem, w48 = contact_solver.solve_plan(_build.load(), w.table.n_contacts, w.n_bodies)
    check(not in_smem, "billiards48's solve: its lane fields should not fit shared memory")
    for label, s in (("pairs", billiards_pairs_state(env, B48)),
                     ("pile", overlap_state(env, B48, 3, *CIRCLE_OVERLAP["billiards48"]))):
        con = collide_batched(w, s)
        err = hold_fwd(f"contact_solve_fwd on billiards48's {label} state",
                       tuple(contact_solver.solve_contacts(w, s, con, *b_args)),
                       tuple(contact_solver.solve_contacts_plain(w, s, con, *b_args)))
        print(f"[kernel] contact_solve_fwd vs plain on billiards48's {label} state at B={B48} "
              f"({w48} worlds a block, lane fields in scratch): max |diff| {err:.3e} <= {ATOL}")
        out["contact_solve_fwd"][f"billiards48_{label}"] = {"max_abs_err": err,
                                                             "worlds_per_block": w48}
        got = contact_solver.solve_contacts_bwd(w, s, con, cot, *b_args)
        want = contact_solver.solve_contacts_bwd_plain(w, s, con, cot, *b_args)
        torch.cuda.synchronize()
        barred = label == "pairs"
        err, share = hold_vjp(f"contact_solve_bwd on billiards48's {label} state",
                              (*got[0], *got[1:]), (*want[0], *want[1:]), barred)

        def d64(x):
            return x.double() if x.is_floating_point() else x

        want64 = contact_solver.solve_contacts_bwd_plain(
            w, type(s)(*map(d64, s)), type(con)(*map(d64, con)), type(cot)(*map(d64, cot)),
            *b_args)
        off = float64_reading((*got[0], *got[1:]), (*want[0], *want[1:]),
                              (*want64[0], *want64[1:]))
        print(f"[kernel] contact_solve_bwd vs plain VJP on billiards48's {label} state at "
              f"B={B48} ({w.n_bodies} bodies, C={w.table.n_contacts}, {int(con.active.sum())} "
              f"active lanes): max |diff| {err:.3e}, {share:.3f} of the bar"
              f"{'' if barred else ' (a reading, no bar)'}; worlds off the float64 VJP by more "
              f"than 1e-3: kernel {off[0]}, plain float32 {off[1]}")
        out["contact_solve_bwd"][f"billiards48_{label}"] = {
            "max_abs_err": err, "share_of_bar": share, "off_float64": off}
    return out


B_LARGE = 1024  # the override world's batch in phase 3, billiards48's gradient's
LARGE_H, LARGE_SEGMENTS = 20, 2  # billiards48's fused gradient (cue_loss_fn)


def large_worlds(gpu):
    """Phase 3 on worlds past the kernels' old limits of 16 parts, 64
    bodies and a 32-bit override mask, each kernel against its plain
    version (forwards: body planes within ATOL, flags identical; reverse
    passes at the bar): billiards48 (52 parts, C=1320) on both fused
    kernels at B48 from its pairs state, the forward keeping its lane
    fields in scratch; billiards61 (65 bodies, C=2074) on all four kernels
    at B48; the override world (``torch_scenarios.override_world``, its
    overridden slab at part 32) on both fused kernels at B_LARGE.  Then
    billiards48's fused step and its plain version timed in turns at B from
    the pairs state, and its reverse pass on a path: the gradient of
    ``cue_loss_fn`` through a LARGE_H-step fused rollout at B_LARGE after
    a warm-up (LARGE_H reverse-pass launches, none of a solver kernel),
    the pass timed against its plain VJP at B_LARGE.  Returns ``{world:
    entry}``."""
    from parallax_tpu_torch.engine.batched import collide_batched, integrate_bm
    from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
    from parallax_tpu_torch.ops import _build, contact_solver, fused_step
    from parallax_tpu_torch.parallel import rollout
    from torch_scenarios import (billiards_pairs_state, cotangents, override_state,
                                 override_world)

    dev = torch.device("cuda")
    lib = _build.load()
    out = {}

    def fused_pair(label, w, s, override, cot):
        got_s, got_c = fused_step.physics_core_fused(w, s, override)
        want_s, want_c = fused_step.fused_step_plain(w, s, override)
        torch.cuda.synchronize()
        n_act = int(want_c.active.sum())
        check(n_act > 0, f"{label}: no active lane")
        err = hold_fwd(f"fused_step_fwd on {label}", (*got_s, got_c.active),
                       (*want_s, want_c.active))
        got = fused_step.fused_step_bwd(w, s, override, cot)
        want = fused_step.fused_step_bwd_plain(w, s, override, cot)
        torch.cuda.synchronize()
        berr, share = hold_vjp(f"fused_step_bwd on {label}", (*got[0], *got[1:]),
                               (*want[0], *want[1:]))
        C, n, P = w.table.n_contacts, w.n_bodies, len(w.parts.nverts)
        tparts = tuple(sorted(override or {}))
        fplan = fused_step._fwd_plan(lib, w, C, n, P, C)
        bplan = fused_step._bwd_plan(lib, w, C, n, P, len(fused_step.fused_operands(w).pair_i))
        print(f"[kernel] fused_step_fwd vs plain on {label} ({n} bodies, {P} parts, C={C}, "
              f"override parts {list(tparts)}) at B={s.px.shape[1]}: {n_act} active lanes, "
              f"flags identical, max |diff| {err:.3e} <= {ATOL} (lane fields in "
              f"{'shared memory' if fplan[0] else 'scratch'}, {fplan[1]} worlds a block)")
        print(f"[kernel] fused_step_bwd vs plain VJP on {label} at B={s.px.shape[1]}: max "
              f"|diff| {berr:.3e}, {share:.3f} of the bar ({bplan[1]} worlds a block, "
              f"{lib.fused_step_bwd_smem_bytes(C, n, P, len(fused_step.fused_operands(w).pair_i), bplan[0])} "
              f"bytes of shared memory a world)")
        return {"fwd": {"max_abs_err": err, "active": n_act, "fields_in_smem": fplan[0],
                        "worlds_per_block": fplan[1]},
                "bwd": {"max_abs_err": berr, "share_of_bar": share,
                        "worlds_per_block": bplan[1]}}

    e48 = Billiards(BilliardsConfig(n_object=47, use_cuda_fused=True))
    w48 = e48.world
    check(len(w48.parts.nverts) == 52, "billiards48: 52 parts")
    s48 = billiards_pairs_state(e48, B48)
    out["billiards48"] = fused_pair("billiards48's pairs state", w48, s48, None,
                                    cotangents(w48.n_bodies, B48, 5, dev))
    check(not out["billiards48"]["fwd"]["fields_in_smem"],
          "billiards48's fused forward: its lane fields should not fit shared memory")

    e61 = Billiards(BilliardsConfig(n_object=60, use_cuda_fused=True))
    w61, ws61 = e61.world, Billiards(BilliardsConfig(n_object=60)).world
    check(w61.n_bodies == 65, "billiards61: 65 bodies")
    s61 = billiards_pairs_state(e61, B48)
    cot61 = cotangents(w61.n_bodies, B48, 5, dev)
    out["billiards61"] = fused_pair("billiards61's pairs state", w61, s61, None, cot61)
    c = ws61.config
    args = (c.solver_iterations, c.position_iterations, c.dt, c.contact)
    si, _ = integrate_bm(ws61, s61)
    con = collide_batched(ws61, si)
    err = hold_fwd("contact_solve_fwd on billiards61",
                   tuple(contact_solver.solve_contacts(ws61, si, con, *args)),
                   tuple(contact_solver.solve_contacts_plain(ws61, si, con, *args)))
    got = contact_solver.solve_contacts_bwd(ws61, si, con, cot61, *args)
    want = contact_solver.solve_contacts_bwd_plain(ws61, si, con, cot61, *args)
    torch.cuda.synchronize()
    berr, share = hold_vjp("contact_solve_bwd on billiards61", (*got[0], *got[1:]),
                           (*want[0], *want[1:]))
    print(f"[kernel] contact_solve_fwd vs plain on billiards61 at B={B48} "
          f"({int(con.active.sum())} active lanes, plan {contact_solver.solve_plan(lib, ws61.table.n_contacts, 65)}): "
          f"max |diff| {err:.3e} <= {ATOL}; contact_solve_bwd vs plain VJP: max |diff| "
          f"{berr:.3e}, {share:.3f} of the bar")
    out["billiards61"]["solve"] = {"max_abs_err": err}
    out["billiards61"]["solve_bwd"] = {"max_abs_err": berr, "share_of_bar": share}

    wo, slab = override_world("cuda")
    so, ovr = override_state(wo, slab, B_LARGE)
    check(slab == 32 and fused_step.fused_operands(wo, (slab,)).part_i[slab, 3].item() == 0,
          "override world: the slab is part 32, rank 0")
    out["override"] = fused_pair("the override world (slab at part 32)", wo, so, ovr,
                                 cotangents(wo.n_bodies, B_LARGE, 5, dev))

    # billiards48's fused step in turns with its plain version at B, and its bound
    sb = billiards_pairs_state(e48, B)
    ms, plain_ms, t = turns(lambda: fused_step.physics_core_fused(w48, sb),
                            lambda: fused_step.fused_step_plain(w48, sb), 3)
    act = fused_step.fused_step_plain(w48, sb)[1].active
    n_act = int(act.sum())
    bound, by, nbytes, ops = fused_bound_ms(w48, [], n_act, B)
    print(f"[time] fused step per call on billiards48 at B={B}: kernel {ms:.4f} ms, plain "
          f"torch {plain_ms:.4f} ms (turns {[round(x, 4) for x in t]}) on {gpu}")
    print(f"[bound] fused step on billiards48 at B={B}, {n_act} active lanes: {bound:.5f} ms "
          f"({by}; {nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M float32 operations)")
    out["billiards48"]["fwd"].update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
    del sb, act

    # billiards48's fused reverse pass on a path, then timed at B_LARGE
    params = mlp_params(dev, e48.observation_size, e48.action_size)
    loss_fn = cue_loss_fn(e48, LARGE_H, LARGE_SEGMENTS)
    states = e48.reset_fn_batch(keys_for(B_LARGE, 7, dev))
    torch.autograd.grad(loss_fn(params, states)[0], list(params.values()))  # warm-up
    torch.cuda.synchronize()
    contact_solver.launches = contact_solver.bwd_launches = 0
    fused_step.launches = fused_step.bwd_launches = 0
    t0 = time.perf_counter()
    loss, _ = loss_fn(params, states)
    grads = torch.autograd.grad(loss, list(params.values()))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = (contact_solver.launches, contact_solver.bwd_launches,
              fused_step.launches, fused_step.bwd_launches)
    check(counts == (0, 0, 2 * LARGE_H, LARGE_H),
          f"billiards48 fused gradient: launches {counts}, want (0, 0, {2 * LARGE_H}, {LARGE_H})")
    check(all(torch.isfinite(g).all().item() for g in grads), "billiards48 gradient: non-finite")
    print(f"[train] billiards48 fused cue objective gradient B={B_LARGE} h={LARGE_H} "
          f"segments={LARGE_SEGMENTS}: loss {loss.item():.6f}, {sec:.3f} s, launches fused fwd "
          f"{counts[2]} bwd {counts[3]}, solver 0, on {gpu}")
    sl = billiards_pairs_state(e48, B_LARGE)
    cot = cotangents(w48.n_bodies, B_LARGE, 5, dev)
    bms, bplain_ms, t = turns(lambda: fused_step.fused_step_bwd(w48, sl, None, cot),
                              lambda: fused_step.fused_step_bwd_plain(w48, sl, None, cot), 2)
    act = fused_step.fused_step_plain(w48, sl)[1].active
    bbound, bby, nbytes, ops = fused_bwd_bound_ms(w48, [], int(act.sum()),
                                                  touched_pairs(w48, act), B_LARGE)
    print(f"[time] fused reverse pass per call on billiards48 at B={B_LARGE}: kernel {bms:.4f} "
          f"ms, plain autograd {bplain_ms:.4f} ms (turns {[round(x, 4) for x in t]}) on {gpu}")
    print(f"[bound] fused reverse pass on billiards48 at B={B_LARGE}: {bbound:.5f} ms ({bby}; "
          f"{nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} M float32 operations)")
    out["billiards48"]["bwd"].update(launches=counts[3], ms=bms, plain_ms=bplain_ms,
                                     bound_ms=bbound, bound_by=bby, grad_s=sec)
    return out


def device_kernels(fn):
    """``(device kernels, device ms)`` of one call of ``fn`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3


def pair_view(world, contacts):
    """``(active, depth)``, each ``[..., pairs]``: per table pair, whether
    any of its lanes is active and its deepest lane's depth (a SAT
    manifold's two lanes are one pair)."""
    act, dep, lane = [], [], 0
    d = contacts.penetration.norm(dim=-1)
    for g in world.table.groups:
        w = 2 if (g.kernel in ("pp", "bp") and world.config.narrowphase == "sat") else 1
        for _ in range(g.size):
            act.append(contacts.active[..., lane:lane + w].any(-1))
            dep.append(d[..., lane:lane + w].amax(-1))
            lane += w
    return torch.stack(act, -1), torch.stack(dep, -1)


DC_CPU_B = 1024  # detect_contacts card against CPU
DC_PEN_ATOL = 1e-4  # card vs CPU penetrations on lanes active in both
DC_FLIPS = 1e-3  # the share of lanes whose flag may differ card vs CPU (knife edges)


def detect_contacts_phase(gpu):
    """The per-world collide, ``World.detect_contacts``, on the card: the
    lander's world (pp pairs on its own ground squares,
    ``torch_scenarios.lander_touch_state``) and the mixed world (cc, cb,
    pp), each built with ``narrowphase="sat"`` and ``"gjk_epa"``, on B
    states on the card.  Per narrow phase: its time (CUDA events) and its
    device kernels a call (torch.profiler), finite values of the table's
    shape; the two narrow phases' per-pair activity equal and their depths
    within 0.01 (``tests/test_reference_modes.py``'s rule); the card
    against the CPU on DC_CPU_B of the states: flags equal but for a
    counted share of at most DC_FLIPS of the lanes, penetrations within
    DC_PEN_ATOL where both are active.  No kernel of the repo runs here:
    the geometry is plain torch, as it is XLA in the JAX package.  Returns
    ``{world: {narrowphase: entry}}``."""
    from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
    from parallax_tpu_torch.ops import contact_solver, fused_step
    from torch_scenarios import lander_touch_state, mixed_state, mixed_world
    from parallax_tpu_torch.engine.batched import _from_soa

    out = {}
    for name in ("lander", "mixed_world"):
        res, views = {}, {}
        for nph in ("sat", "gjk_epa"):
            if name == "lander":
                world = LunarLander(LanderConfig(narrowphase=nph)).world
                cpu_env = LunarLander(LanderConfig(narrowphase=nph), device="cpu")
                cpu_world, st = cpu_env.world, lander_touch_state(cpu_env, B)
            else:
                world, state = mixed_world("cuda", narrowphase=nph, use_cuda_fused=False)
                cpu_world, cstate = mixed_world("cpu", narrowphase=nph, use_cuda_fused=False)
                st = _from_soa(mixed_state(cpu_world, cstate, B))
            gst = type(st)(*(x.cuda() for x in st))
            counts = (contact_solver.launches, fused_step.launches)
            got = world.detect_contacts(gst)
            torch.cuda.synchronize()
            check((contact_solver.launches, fused_step.launches) == counts,
                  f"{name} {nph}: detect_contacts launched a kernel of the repo")
            C = world.table.n_contacts
            check(tuple(got.active.shape) == (B, C) and tuple(got.penetration.shape) == (B, C, 2),
                  f"{name} {nph}: contact buffer shape {tuple(got.penetration.shape)}")
            check(bool(torch.isfinite(got.penetration).all() & torch.isfinite(got.point).all()),
                  f"{name} {nph}: non-finite contacts")
            n_active = int(got.active.sum())
            check(n_active > 0, f"{name} {nph}: no active lane")
            fn = lambda: world.detect_contacts(gst)  # noqa: E731
            cuda_ms(fn, 1)
            ms = min(cuda_ms(fn, 3) for _ in range(2))
            kernels, dev_ms = device_kernels(fn)
            # card against CPU on the first DC_CPU_B states
            sub = type(st)(*(x[:DC_CPU_B] for x in st))
            ref = cpu_world.detect_contacts(sub)
            g_act, r_act = got.active[:DC_CPU_B].cpu(), ref.active
            flips = int((g_act != r_act).sum())
            check(flips <= DC_FLIPS * g_act.numel(),
                  f"{name} {nph}: {flips} flags differ card vs CPU")
            both = g_act & r_act
            pen_err = (got.penetration[:DC_CPU_B].cpu() - ref.penetration).abs().amax(-1)[both]
            pen_err = pen_err.max().item() if pen_err.numel() else 0.0
            check(pen_err <= DC_PEN_ATOL, f"{name} {nph}: card vs CPU penetration {pen_err}")
            views[nph] = pair_view(world, got)
            res[nph] = {"ms": ms, "device_kernels": kernels, "device_ms": dev_ms, "lanes": C,
                        "active": n_active, "cpu_flag_flips": flips, "cpu_max_abs_err": pen_err}
            print(f"[geometry] {name} detect_contacts narrowphase={nph} B={B} (C={C}): "
                  f"{ms:.3f} ms a call, {kernels} device kernels ({dev_ms:.3f} ms of device "
                  f"time), {n_active} active lanes; card vs CPU at B={DC_CPU_B}: {flips} flags "
                  f"differ, max |pen diff| {pen_err:.3e} where both are active, on {gpu}")
            del got, gst
        (a_sat, d_sat), (a_ref, d_ref) = views["sat"], views["gjk_epa"]
        same = int((a_sat != a_ref).sum())
        both = a_sat & a_ref
        dd = (d_sat - d_ref).abs()[both].max().item()
        check(same == 0, f"{name}: {same} pairs differ in activity between the narrow phases")
        check(dd < 0.01, f"{name}: SAT and GJK/EPA depths differ by {dd}")
        print(f"[geometry] {name}: SAT and GJK/EPA agree on every pair's activity "
              f"({int(a_sat.sum())} active pairs), depths within {dd:.3e} (< 0.01)")
        res["depth_diff"] = dd
        out[name] = res
    return out


WS_CPU_B = 1024  # World.step card against CPU
WS_POS_ATOL, WS_VEL_ATOL = 1e-4, 1e-3  # card vs CPU after one step, where the choices agree
WS_FLIPS = 1e-3  # the share of worlds whose contact flags or chosen lanes may differ
# the share of worlds whose contact buffers may differ beyond 1e-5 (EPA on a
# circle stopping a step apart: the allowance tests/test_torch_narrowphase.py
# holds JAX's EPA to)
WS_EPA_SHARE = 0.03
WS_STEPS = 3
SOLVER_MODES = ("block", "jacobi", "gauss_seidel", "random_one_per_body")


def step_choices(world, out, con, key):
    """What a step chose in each world, ``[B, k]``: its contact flags, and
    in the random modes each body's chosen lane (``random_one_per_body``,
    from the step's contacts and key) or chosen ``all_contacts`` entry (the
    keyed replay, on the step's integrated positions: it moves velocities
    only).  Recomputed from the step's own inputs, so two devices' runs
    can be compared choice for choice."""
    from parallax_tpu_torch.dynamics import solver
    from parallax_tpu_torch.engine import ref_replay

    mode = world.config.solver_mode
    parts = [con.active.long()]
    if mode == "random_one_per_body":
        parts.append(solver.choose_lanes(con, world.table.body_a, world.table.body_b,
                                         world.n_bodies, key)[0])
    elif mode == "random_one_per_body_keyed":
        p = world.parts
        plan = ref_replay.build_replay_plan(p.kind, p.nverts, p.body, world.n_bodies)
        parts.append(ref_replay.keyed_choice(world.world_parts(out), plan, key)[2])
    return torch.cat(parts, -1)


def world_step_phase(gpu):
    """Phase 3c: the per-world step, ``World.step``, on the card.  It is
    plain torch, as the JAX package's is XLA code: no kernel of the repo
    runs (the launch counts stay).

    (a) The crate pile (``torch_scenarios.crate_world``, 14 bodies, C=88)
    at B, ``sat`` + ``block``: ``World.step`` against ``step_batched`` (the
    split step with its solve kernel) on the same states at JAX's bar (pos
    1e-5, vel 1e-4, omega 1e-3), each one's ms a step (CUDA events, best
    of two means of 3) and device kernels a step (torch.profiler).
    (b) The config matrix's world (``torch_scenarios.matrix_world``) at B
    under each (narrowphase, solver_mode) of {sat, gjk_epa} x {block,
    jacobi, gauss_seidel, random_one_per_body}, and the keyed replay on
    BASELINE config 3's stack (the replay refuses the matrix world, as
    JAX's does): WS_STEPS steps with per-world keys, timed together (CUDA
    events), finite, and device kernels a step; the card against the CPU
    at WS_CPU_B, one step from the same states and keys: worlds whose
    contact flags or chosen lanes differ counted (at most WS_FLIPS of
    them), worlds whose contact buffers differ beyond 1e-5 (EPA on a circle
    stopping a step apart) counted (at most WS_EPA_SHARE), the others
    within WS_POS_ATOL and WS_VEL_ATOL.
    (c) Config 3's golden rollout (300 steps, B=1, the golden key stream)
    on the card against ``tests/golden/golden_parity.npz`` at the CPU
    test's bars.  Returns ``{case: entry}``."""
    from parallax_tpu_torch.engine.batched import _from_soa, step_batched
    from parallax_tpu_torch.ops import contact_solver, fused_step
    from parallax_tpu_torch.utils import convert
    from torch_scenarios import (batch_state, crate_overlap_state, crate_world, golden_rollout,
                                 hold_config3, matrix_world, stack_touch_state, stack_world,
                                 world_keys)

    def timed(fn):
        fn()
        ms = min(cuda_ms(fn, 3) for _ in range(2))
        return ms, device_kernels(fn)

    out = {}
    counts = (contact_solver.launches, fused_step.launches)
    with torch.no_grad():
        # (a) block mode against the batched step
        world, _ = crate_world("cuda")
        st = _from_soa(crate_overlap_state(world, B))
        got, con = world.step(st)
        check((contact_solver.launches, fused_step.launches) == counts,
              "crate pile: World.step launched a kernel of the repo")
        want = step_batched(world, st)[0]
        torch.cuda.synchronize()
        errs = {f: (getattr(got, f) - getattr(want, f)).abs().max().item()
                for f in ("pos", "vel", "omega")}
        for f, bar in (("pos", 1e-5), ("vel", 1e-4), ("omega", 1e-3)):
            check(errs[f] <= bar, f"crate pile: World.step against step_batched {f} {errs[f]}")
        check(bool(con.active.any()), "crate pile: no active lane")
        entry = {"max_abs_err": errs}
        for label, fn in (("World.step", lambda: world.step(st)),
                          ("step_batched", lambda: step_batched(world, st))):
            ms, (kernels, dev_ms) = timed(fn)
            entry[label] = {"ms": ms, "device_kernels": kernels, "device_ms": dev_ms}
            print(f"[world.step] crate pile {label} B={B} (14 bodies, C=88, sat+block): "
                  f"{ms:.3f} ms a step, {kernels} device kernels a step ({dev_ms:.3f} ms of "
                  f"device time), on {gpu}")
        print(f"[world.step] crate pile World.step against step_batched: max |diff| pos "
              f"{errs['pos']:.3e}, vel {errs['vel']:.3e}, omega {errs['omega']:.3e}")
        out["crate_block"] = entry
        del st, got, want, con

        # (b) every mode on the card, then the card against the CPU
        cases = [(f"matrix {nph} {mode}", lambda d, nph=nph, mode=mode: matrix_world(nph, mode, d))
                 for nph in ("sat", "gjk_epa") for mode in SOLVER_MODES]
        cases.append(("stack gjk_epa random_one_per_body_keyed",
                      lambda d: stack_world(d, solver_mode="random_one_per_body_keyed")))
        for label, make in cases:
            counts = (contact_solver.launches, fused_step.launches)
            world, st0 = make("cuda")
            cpu_world, cst0 = make("cpu")
            if label.startswith("stack"):
                cst = stack_touch_state(cpu_world, cst0, B, seed=3)
            else:
                cst = batch_state(cst0, B, seed=3)
            keys = [world_keys(B, 10 + t).cuda() for t in range(WS_STEPS)]
            # the states enter the card as numpy arrays, as a state taken
            # elsewhere would (utils/convert.py)
            gst = convert.body_state_from_numpy(convert.body_state_to_numpy(cst))
            # WS_STEPS steps with per-world keys, timed together (CUDA events)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s = gst
            start.record()
            for t in range(WS_STEPS):
                s, con = world.step(s, key=keys[t])
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / WS_STEPS
            check((contact_solver.launches, fused_step.launches) == counts,
                  f"{label}: World.step launched a kernel of the repo")
            check(bool(torch.isfinite(s.pos).all() & torch.isfinite(s.vel).all()
                       & torch.isfinite(s.omega).all()), f"{label}: non-finite state")
            kernels, dev_ms = device_kernels(lambda: world.step(gst, key=keys[0]))
            # card against CPU, one step from the first WS_CPU_B states
            sub = type(cst)(*(x[:WS_CPU_B] for x in cst))
            k0 = keys[0][:WS_CPU_B]
            ref, rcon = cpu_world.step(sub, key=k0.cpu())
            got, gcon = world.step(type(sub)(*(x[:WS_CPU_B] for x in gst)), key=k0)
            same = (step_choices(world, got, gcon, k0).cpu()
                    == step_choices(cpu_world, ref, rcon, k0.cpu())).all(-1)
            flips = int((~same).sum())
            # worlds whose contact buffers differ beyond 1e-5 on lanes active
            # on both sides: EPA on a circle stopping a step apart
            both = gcon.active.cpu() & rcon.active
            cdiff = torch.maximum((gcon.penetration.cpu() - rcon.penetration).abs().amax(-1),
                                  (gcon.point.cpu() - rcon.point).abs().amax(-1))
            cdiff = torch.where(both, cdiff, 0.0).amax(-1)
            epa = int((cdiff > 1e-5).sum())
            check(flips <= WS_FLIPS * WS_CPU_B, f"{label}: {flips} worlds chose differently "
                  "card vs CPU")
            check(epa <= WS_EPA_SHARE * WS_CPU_B, f"{label}: {epa} worlds' contacts differ "
                  "card vs CPU")
            held = same & (cdiff <= 1e-5)
            pos_err = (got.pos.cpu() - ref.pos)[held].abs().max().item()
            vel_err = (got.vel.cpu() - ref.vel)[held].abs().max().item()
            check(pos_err <= WS_POS_ATOL and vel_err <= WS_VEL_ATOL,
                  f"{label}: card vs CPU pos {pos_err}, vel {vel_err}")
            n_active = int(con.active.sum())
            out[label] = {"ms": ms, "device_kernels": kernels, "device_ms": dev_ms,
                          "lanes": world.table.n_contacts, "active": n_active,
                          "cpu_choice_flips": flips, "cpu_epa_worlds": epa,
                          "cpu_contact_diff": cdiff.max().item(), "cpu_pos_err": pos_err,
                          "cpu_vel_err": vel_err}
            print(f"[world.step] {label} B={B} (C={world.table.n_contacts}): {ms:.3f} ms a step "
                  f"(mean of {WS_STEPS}), {kernels} device kernels a step ({dev_ms:.3f} ms of "
                  f"device time), finite; card vs CPU at B={WS_CPU_B}: {flips} worlds chose "
                  f"differently, {epa} worlds' contacts differ beyond 1e-5 (at most "
                  f"{cdiff.max().item():.3e}), max |diff| pos {pos_err:.3e}, vel {vel_err:.3e} "
                  f"elsewhere, on {gpu}")
            del s, gst, got, con, gcon

        # (c) config 3's golden rollout on the card
        world, state = stack_world("cuda")
        golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                      "golden", "golden_parity.npz"))["config3"]
        t0 = time.perf_counter()
        frames = golden_rollout(world, type(state)(*(x[None] for x in state)), 300, 20, [303])
        sec = time.perf_counter() - t0
        try:
            errs = tuple(float(e) for e in hold_config3(frames[:, 0], golden))
        except AssertionError as e:
            fail(f"golden config 3 on the card: {e}")
        out["golden_config3"] = {"seconds": sec, "max_abs_err": errs}
        print(f"[world.step] golden config 3 on the card (300 steps, B=1): {sec:.2f} s; max |diff| "
              f"first 4 frames {errs[0]:.3e}, positions {errs[1]:.3e}, velocities and angles "
              f"{errs[2]:.3e}, final heights {errs[3]:.3e}, on {gpu}")
    return out


EA_STEPS = 20  # (a) chained per-world steps at B
EA_CPU_B = 1024  # (c): the card against the CPU
# (d): the CPU's evaluate of 1,024 worlds takes some 110 s on an 8-core
# host; 256 worlds keep the phase near 150 s
EA_EVAL_CPU_B = 256
EA_EVAL = dict(eval_period=3.0, num_nfes=30, wfe_scale=10)  # the example's evaluate
EA_EVAL_RTOL = 1e-3  # (d): rewards and the throttle gradient, card vs CPU


def busy_ms(fn):
    """``(device kernels, device ms)`` of one call of ``fn`` after a warm-up
    call (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    return device_kernels(fn)


def chained_ms(step, st, acts):
    """Host-clock ms a step of ``len(acts)`` chained steps, one sync at the
    end; returns ``(ms, final state)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in acts:
        st, _ = step(st, a)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(acts), st


def timed_steps(name, label, step, st, acts, gpu):
    """EA_STEPS chained steps of ``step`` from ``st`` after a warm-up step,
    then one profiled step: ``({ms, device_kernels, device_ms, busy_share},
    (solve launches, fused step launches) in the chain)``, printed."""
    step(st, acts[0])
    before = kernel_counts()
    ms, _ = chained_ms(step, st, acts)
    solves, _, steps, _ = (a - b for a, b in zip(kernel_counts(), before))
    kernels, dev_ms = busy_ms(lambda: step(st, acts[0]))
    print(f"[env-api] {name} {label} B={B}: {ms:.3f} ms a step (host clock, {EA_STEPS} "
          f"chained, one sync), {kernels} device kernels a step ({dev_ms:.3f} ms of device "
          f"time, busy {dev_ms / ms:.3f}); {solves} solve and {steps} fused step launches in "
          f"the chain, on {gpu}")
    return ({"ms": ms, "device_kernels": kernels, "device_ms": dev_ms, "busy_share": dev_ms / ms},
            (solves, steps))


def step_fn_batch_legs(gpu):
    """Phase 3d (g): ``PlaneEnvMixin.step_fn_batch``, the raw plane step (no
    watchdog, no auto-reset), on the split lander, the fused lander
    (``LanderConfig(use_cuda_fused=True, broadphase=False)``) and split
    RoboCup, from the phase's scenes.
    (a) At B, EA_STEPS chained steps beside ``step_batch`` (``env.step`` is
    (a) above): ms a step, device kernels a step, busy share; the split
    worlds launch the solve kernel and no fused step, the fused lander the
    fused step and no solve.
    (b) One step from the same states against ``step_batch``: on the worlds
    ``step_batch`` does not reset, bodies, reward, obs, terminated and t
    equal to the bit (one helper, ``_plane_step``, runs both), and the key
    is the input key.
    (c) At EA_CPU_B, one step card against CPU at phase 4's bars: at least
    CPU_DONE_SHARE of the worlds with equal flags, on them obs and reward
    within CPU_ATOL; on the landers the gradient of ``ts.reward.sum()``
    with respect to the actions within GRAD_RTOL in norm (phase 6's bar),
    through the solve's reverse kernel (split) and the fused step's
    (fused).
    (d) A reference-mode RoboCup (``narrowphase="gjk_epa"``,
    ``solver_mode="random_one_per_body"``) on CUDA tensors:
    ``step_fn_batch`` raises ``ValueError`` and launches no kernel."""
    from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
    from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig
    from parallax_tpu_torch.utils.pytree import tree_map
    from torch_scenarios import env_actions, lander_scene, robocup_scene

    dev = torch.device("cuda")
    fused_cfg = LanderConfig(use_cuda_fused=True, broadphase=False)
    legs = {"lander": (lambda d: LunarLander(device=d), lander_scene),
            "lander_fused": (lambda d: LunarLander(fused_cfg, device=d), lander_scene),
            "robocup": (lambda d: RoboCup(device=d), robocup_scene)}
    out = {}
    for name, (make, scene) in legs.items():
        env, env_cpu = make("cuda"), make("cpu")
        fused = name == "lander_fused"
        entry = {}
        with torch.no_grad():
            st = scene(env, B, seed=3)
            acts = env_actions(env, EA_STEPS, B, seed=4)
            # (a) timed beside step_batch
            for label, step in (("step_batch", env.step_batch),
                                ("step_fn_batch", env.step_fn_batch)):
                entry[label], (solves, steps) = timed_steps(name, label, step, st, acts, gpu)
                check((steps > 0 and solves == 0) if fused else (solves > 0 and steps == 0),
                      f"{name} {label}: {solves} solve and {steps} fused step launches")
                entry[label].update(solve_launches=solves, fused_launches=steps)
            # (b) one step against step_batch, to the bit where step_batch keeps the world
            got, ts = env.step_fn_batch(st, acts[0])
            want, wts = env.step_batch(st, acts[0])
            keep = ~wts.done
            check(bool(keep.any()) and not bool(keep.all()), f"{name}: scene does not mix")
            pairs = [(getattr(got.bodies, f), getattr(want.bodies, f)) for f in got.bodies._fields]
            pairs += [(ts.reward, wts.reward), (ts.obs, wts.obs),
                      (ts.terminated, wts.terminated), (got.t, want.t)]
            check(all(torch.equal(a[keep], b[keep]) for a, b in pairs),
                  f"{name}: step_fn_batch differs from step_batch on a world it keeps")
            check(torch.equal(got.key, st.key), f"{name}: step_fn_batch changed the key")
            entry["vs_step_batch"] = {"worlds_kept": int(keep.sum()), "bitwise": True}
            print(f"[env-api] {name} step_fn_batch against step_batch, one step at B={B}: "
                  f"bodies, reward, obs, terminated and t equal to the bit on the "
                  f"{int(keep.sum())} worlds step_batch keeps; the key unchanged")
            del st, acts, got, want
        # (c) card against CPU, values and the gradient wrt the actions
        cst = scene(env_cpu, EA_CPU_B, seed=5)
        gst = tree_map(lambda x: x.to(dev), cst)
        ca = env_actions(env_cpu, 1, EA_CPU_B, seed=6)[0]
        res = {}
        for d, e, s in (("cuda", env, gst), ("cpu", env_cpu, cst)):
            a = ca.to(d).requires_grad_(name != "robocup")
            before = kernel_counts()
            _, rts = e.step_fn_batch(s, a)
            grad = torch.autograd.grad(rts.reward.sum(), a)[0].cpu() if a.requires_grad else None
            res[d] = (tree_map(lambda x: x.detach().cpu(), rts), grad,
                      [x - y for x, y in zip(kernel_counts(), before)])
        (g, gg, counts), (c, cg, _) = res["cuda"], res["cpu"]
        same = (g.terminated == c.terminated) & (g.truncated == c.truncated)
        share = same.double().mean().item()
        oerr = (g.obs - c.obs)[same].abs().max().item()
        rerr = (g.reward - c.reward)[same].abs().max().item()
        check(share >= CPU_DONE_SHARE and oerr <= CPU_ATOL and rerr <= CPU_ATOL,
              f"{name} step_fn_batch card vs CPU: flags {share}, obs {oerr}, reward {rerr}")
        entry["vs_cpu"] = {"B": EA_CPU_B, "flags_share": share, "obs_err": oerr,
                           "reward_err": rerr}
        msg = ""
        if gg is not None:
            grel = ((gg - cg).norm() / cg.norm()).item()
            bwd = counts[3] if fused else counts[1]
            check(bwd > 0 and (counts[1] == 0 if fused else counts[3] == 0),
                  f"{name}: reverse launches {counts}")
            check(np.isfinite(grel) and grel <= GRAD_RTOL,
                  f"{name} step_fn_batch d(reward)/d(actions): card vs CPU rel diff {grel}")
            entry["vs_cpu"].update(grad_rel=grel, reverse_launches=bwd)
            msg = (f"; d(reward.sum())/d(actions) rel diff in norm {grel:.2e} ({bwd} "
                   f"{'fused step' if fused else 'solve'} reverse launch)")
        print(f"[env-api] {name} step_fn_batch card vs CPU, one step at B={EA_CPU_B}: "
              f"{share:.4f} of the worlds with equal flags, on them max |diff| obs "
              f"{oerr:.3e}, reward {rerr:.3e}{msg}")
        out[name] = entry
    # (d) the reference modes are refused on the card, as in the JAX package
    ref = RoboCup(RoboCupConfig(narrowphase="gjk_epa", solver_mode="random_one_per_body"),
                  device="cuda")
    rst = ref.reset_fn_batch(keys_for(8, 60, dev))
    before = kernel_counts()
    try:
        ref.step_fn_batch(rst, torch.full((8, ref.action_size), 0.5, device=dev))
        fail("reference-mode RoboCup: step_fn_batch ran on the card")
    except ValueError as e:
        check(kernel_counts() == before, "reference-mode RoboCup: a kernel launched")
        out["reference_refused"] = str(e)[:120]
    print(f"[env-api] reference-mode RoboCup step_fn_batch on the card: ValueError "
          f"({out['reference_refused']})")
    return out


def env_api_phase(gpu):
    """Phase 3d: the per-world env API (``envs/base.py``) on the card.
    ``Environment.step`` runs ``World.step`` per world, plain torch as the
    JAX package's is XLA code: no kernel of the repo runs on this path.

    (a) The lander and RoboCup at B, SAT and block, from their scenes
    (``torch_scenarios.lander_scene``/``robocup_scene``: contacts, landings,
    crashes and goals): ``env.step`` and the plane-space ``step_batch``
    (which launches the solve kernel), EA_STEPS chained steps each, ms a
    step (host clock, one sync), device kernels a step and the device's
    busy share of a step (torch.profiler's device time over the host ms).
    (b) One step from the same states, ``env.step`` against ``step_batch``:
    positions 1e-5, velocities 1e-4, done flags identical.
    (c) The card against the CPU at EA_CPU_B, EA_STEPS per-world steps:
    at least CPU_DONE_SHARE of the worlds with equal done sequences, and
    on those obs and reward within CPU_ATOL.
    (d) ``evaluate`` with ``LanderJudge`` and ``make_world_forward`` at B
    worlds, each its own terrain and throttle (a quarter drifting out of
    bounds), 30 NFE x 10 WFE: its seconds, finite, the drifting worlds'
    crash in their rewards; the first EA_EVAL_CPU_B worlds' rewards within
    EA_EVAL_RTOL relative of the CPU's; the example's gradient of the
    return with respect to the throttle at B=1 finite and within
    EA_EVAL_RTOL relative of the CPU's.
    (e) Golden configs 4, 4k and 5 on the card at the CPU test's bars
    (``torch_scenarios.hold_golden_env``).
    (f) The utils: ``dbc`` in fleet mode poisons one world of B, which
    alone is truncated and reset while the fleet steps on; a checkpoint of
    a card fleet with its policy and Adam state continues 3 train steps
    bitwise as the unbroken run; ``Renderer.render_env`` of a card state
    draws.
    (g) ``step_fn_batch`` on the kernels: :func:`step_fn_batch_legs`.
    Returns ``{case: entry}``."""
    from parallax_tpu_torch.envs.base import ConstantControl, evaluate
    from parallax_tpu_torch.envs.lunar_lander import LanderJudge, LunarLander, make_world_forward
    from parallax_tpu_torch.envs.robocup import RoboCup
    from parallax_tpu_torch.parallel.rollout import adam, make_train_step
    from parallax_tpu_torch.utils import checkpoint, dbc
    from parallax_tpu_torch.utils.pytree import tree_leaves, tree_map
    from parallax_tpu_torch.viz import Renderer
    from torch_scenarios import (GOLDEN_ENV_CASES, env_actions, golden_env_case, hold_golden_env,
                                 lander_scene, robocup_scene)

    out = {}
    dev = torch.device("cuda")
    with torch.no_grad():
        for name, cls, scene in (("lander", LunarLander, lander_scene),
                                 ("robocup", RoboCup, robocup_scene)):
            env, env_cpu = cls(device="cuda"), cls(device="cpu")
            st = scene(env, B, seed=3)
            acts = env_actions(env, EA_STEPS, B, seed=4)
            entry = {}
            # (a) per-world against plane-space steps, each timed and profiled
            for label, step in (("env.step", env.step), ("step_batch", env.step_batch)):
                entry[label], launched = timed_steps(name, label, step, st, acts, gpu)
                if label == "env.step":
                    check(launched == (0, 0), f"{name}: env.step launched a kernel of the repo")
                else:
                    check(launched[0] > 0, f"{name}: step_batch launched no solve kernel")
            # (b) one step, per-world against plane
            got, ts = env.step(st, acts[0])
            want, wts = env.step_batch(st, acts[0])
            errs = {f: (getattr(got.bodies, f) - getattr(want.bodies, f)).abs().max().item()
                    for f in ("pos", "vel")}
            check(errs["pos"] <= 1e-5 and errs["vel"] <= 1e-4,
                  f"{name}: env.step against step_batch {errs}")
            check(torch.equal(ts.done, wts.done), f"{name}: done flags differ from step_batch")
            check(bool(ts.done.any()) and not bool(ts.done.all()), f"{name}: scene does not mix")
            entry["vs_step_batch"] = errs
            print(f"[env-api] {name} env.step against step_batch, one step at B={B}: max |diff| "
                  f"pos {errs['pos']:.3e}, vel {errs['vel']:.3e}, done flags equal "
                  f"({int(ts.done.sum())} done)")
            # (c) card against CPU
            cst = scene(env_cpu, EA_CPU_B, seed=5)
            gst = tree_map(lambda x: x.to(dev), cst)
            ca = env_actions(env_cpu, EA_STEPS, EA_CPU_B, seed=6)
            dones, obs, rew = [], [], []
            for a in ca:
                cst, cts = env_cpu.step(cst, a)
                gst, gts = env.step(gst, a.to(dev))
                dones.append((cts.done, gts.done.cpu()))
                obs.append((cts.obs, gts.obs.cpu()))
                rew.append((cts.reward, gts.reward.cpu()))
            same = torch.ones(EA_CPU_B, dtype=torch.bool)
            for c, g in dones:
                same &= c == g
            share = same.float().mean().item()
            check(share >= CPU_DONE_SHARE, f"{name}: card vs CPU equal done sequences {share}")
            oerr = max((c - g)[same].abs().max().item() for c, g in obs)
            rerr = max((c - g)[same].abs().max().item() for c, g in rew)
            check(oerr <= CPU_ATOL and rerr <= CPU_ATOL,
                  f"{name}: card vs CPU obs {oerr}, reward {rerr}")
            entry["vs_cpu"] = {"done_share": share, "obs_err": oerr, "reward_err": rerr}
            print(f"[env-api] {name} card vs CPU, {EA_STEPS} per-world steps at B={EA_CPU_B}: "
                  f"{share:.4f} of the worlds with equal done sequences, on them max |diff| "
                  f"obs {oerr:.3e}, reward {rerr:.3e}")
            out[name] = entry
            del st, got, want, gst

        # (d) evaluate at B, each world its own terrain and throttle
        env, env_cpu = LunarLander(device="cuda"), LunarLander(device="cpu")
        st = env.reset_fn(keys_for(B, 40, dev))
        drift = torch.arange(B, device=dev) % 4 == 0
        pos, vel = st.bodies.pos.clone(), st.bodies.vel.clone()
        pos[drift, :3, 0] += 13.0
        vel[drift, :3, 0] = 4.0
        bodies = st.bodies._replace(pos=pos, vel=vel)
        thr = torch.from_numpy(np.random.default_rng(41).uniform(0, 1, B).astype(np.float32))
        signal = torch.stack([thr, torch.zeros_like(thr)], -1)

        def run(env, bodies, terrain, signal):
            return evaluate(make_world_forward(env, terrain), bodies, ConstantControl(signal),
                            LanderJudge(env, terrain), **EA_EVAL)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, reward = run(env, bodies, st.terrain, signal.to(dev))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        check(bool(torch.isfinite(reward).all() & torch.isfinite(final.pos).all()),
              "evaluate: non-finite")
        check(bool((reward[drift] < -50.0).all()), "evaluate: a drifting world did not crash")
        sub = slice(0, EA_EVAL_CPU_B)
        t0 = time.perf_counter()
        _, creward = run(env_cpu, type(bodies)(*(x[sub].cpu() for x in bodies)),
                         st.terrain[sub].cpu(), signal[sub])
        cpu_sec = time.perf_counter() - t0
        rel = ((reward[sub].cpu() - creward).abs() / creward.abs()).max().item()
        check(rel <= EA_EVAL_RTOL, f"evaluate: card vs CPU rewards rel diff {rel}")
    # the example's gradient at B=1, card and CPU
    grads = {}
    for d, e in (("cuda", env), ("cpu", env_cpu)):
        s1 = e.reset(torch.tensor([0, 1], device=d))
        u = torch.tensor(0.25, device=d, requires_grad=True)
        _, r = run(e, s1.bodies, s1.terrain, torch.stack([u, torch.zeros_like(u)]))
        r.backward()
        grads[d] = u.grad.item()
    grel = abs(grads["cuda"] - grads["cpu"]) / abs(grads["cpu"])
    check(np.isfinite(grads["cuda"]) and grel <= EA_EVAL_RTOL,
          f"evaluate gradient: card {grads['cuda']} vs CPU {grads['cpu']}")
    out["evaluate"] = {"B": B, "seconds": sec, "cpu_B": EA_EVAL_CPU_B, "cpu_seconds": cpu_sec,
                       "cpu_reward_rel": rel, "grad_cuda": grads["cuda"], "grad_cpu": grads["cpu"],
                       "grad_rel": grel}
    print(f"[env-api] evaluate (LanderJudge, 30 NFE x 10 WFE) at B={B}: {sec:.2f} s, finite, "
          f"the drifting worlds crashed; card vs CPU at B={EA_EVAL_CPU_B} ({cpu_sec:.1f} s on the "
          f"CPU): rewards max rel diff {rel:.3e}; d(return)/d(throttle) at B=1: card "
          f"{grads['cuda']:.6f}, CPU {grads['cpu']:.6f} (rel {grel:.2e}), on {gpu}")

    # (e) golden configs 4, 4k and 5 on the card
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden",
                                  "golden_parity.npz"))
    for name in GOLDEN_ENV_CASES:
        t0 = time.perf_counter()
        got = golden_env_case(name, "cuda")
        sec = time.perf_counter() - t0
        try:
            errs = hold_golden_env(name, got, golden)
        except AssertionError as e:
            fail(f"golden {name} on the card: {e}")
        out[f"golden_{name}"] = {"seconds": sec, "frames_err": errs[0], "reward_err": errs[1]}
        print(f"[env-api] golden {name} on the card: {sec:.2f} s; max |diff| frames "
              f"{errs[0]:.3e}, rewards {errs[1]:.3e}")

    # (f) the utils on the card: dbc in fleet mode
    env = LunarLander(device="cuda")
    with torch.no_grad():
        st = env.reset_fn(keys_for(B, 50, dev))
        a = env_actions(env, 4, B, seed=51)
        bad = B // 2 + 7
        ok = torch.arange(B, device=dev) != bad
        dbc.set_debug_checks(True)
        dbc.set_raise_on_violation(False)
        try:
            pos = dbc.check(ok, "chip_smoke: world in bounds", st.bodies.pos)
            counts = dbc.violation_counts()
        finally:
            dbc.set_raise_on_violation(True)
            dbc.set_debug_checks(False)
            dbc.clear_violations()
        check(counts.get("chip_smoke: world in bounds") == 1, f"dbc: counts {counts}")
        clean, _ = env.step(st, a[0])
        poisoned, ts = env.step(st._replace(bodies=st.bodies._replace(pos=pos)), a[0])
        check(torch.equal(ts.truncated, ~ok), "dbc: the truncated worlds are not the poisoned one")
        for g, c in zip(tree_leaves(poisoned), tree_leaves(clean)):
            check(torch.equal(g[ok], c[ok]), "dbc: a healthy world changed")
        s = poisoned
        for t in range(1, 4):
            s, _ = env.step(s, a[t])
        check(bool(torch.isfinite(s.bodies.pos).all()), "dbc: the fleet did not run on")
    out["dbc_fleet"] = {"B": B, "poisoned_world": bad, "truncated": int(ts.truncated.sum())}
    print(f"[env-api] dbc fleet mode at B={B}: world {bad} poisoned, truncated and reset alone, "
          "the other worlds' bits equal the clean step's, the fleet stepped on finite")

    # the utils on the card: a checkpoint resumes bitwise
    def policy(p, obs):
        return torch.tanh(obs @ p["w"] + p["b"])

    rng = np.random.default_rng(52)
    params = {"w": torch.tensor(rng.standard_normal((9, 2)) * 0.1, dtype=torch.float32,
                                device=dev, requires_grad=True),
              "b": torch.zeros(2, device=dev, requires_grad=True)}
    opt = adam(params)
    step = make_train_step(env, policy, opt, 8)
    states = env.reset_fn_batch(keys_for(EA_CPU_B, 53, dev))
    # the backward's gathers accumulate with atomics on the card unless
    # torch runs its deterministic algorithms; both runs run them
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    params, states, _ = step(params, states)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "env_api_ckpt.pt")
    checkpoint.save(path, {"params": params, "opt": opt.state_dict(), "states": states})
    target = {"params": {k: v.detach().clone() for k, v in params.items()},
              "opt": opt.state_dict(), "states": states}
    runs = []
    for resumed in (False, True):
        if resumed:
            r = checkpoint.restore(path, target)
            params = {k: v.requires_grad_(True) for k, v in r["params"].items()}
            opt = adam(params)
            opt.load_state_dict(r["opt"])
            step, states = make_train_step(env, policy, opt, 8), r["states"]
        p, s = params, states
        rets = []
        for _ in range(3):
            p, s, m = step(p, s)
            rets.append(m["mean_return"].item())
        runs.append((rets, [x.detach().clone() for x in p.values()], s))
    torch.use_deterministic_algorithms(False)
    os.remove(path)
    (ra, pa, sa), (rb, pb, sb) = runs
    check(ra == rb and all(torch.equal(x, y) for x, y in zip(pa, pb))
          and all(torch.equal(x, y) for x, y in zip(tree_leaves(sa), tree_leaves(sb))),
          f"checkpoint: the resumed run differs ({ra} vs {rb})")
    check(all(x.is_cuda for x in tree_leaves(sb)), "checkpoint: restored off the card")
    out["checkpoint"] = {"B": EA_CPU_B, "returns": ra}
    print(f"[env-api] checkpoint of a card fleet (B={EA_CPU_B}, policy, Adam state) resumed: "
          f"3 train steps bitwise equal to the unbroken run (returns {ra})")

    # the utils on the card: the renderer draws a card state
    one = env.reset(torch.tensor([0, 0], device=dev))
    frame = Renderer(160, 120).render_env(env, one)
    check(frame.shape == (120, 160, 3) and int((frame > 0).any(-1).sum()) > 0,
          "renderer: nothing drawn")
    out["renderer"] = {"pixels_drawn": int((frame > 0).any(-1).sum())}
    print(f"[env-api] Renderer.render_env of a card state: {out['renderer']['pixels_drawn']} "
          "pixels drawn")

    t0 = time.perf_counter()
    out["step_fn_batch"] = step_fn_batch_legs(gpu)
    out["step_fn_batch"]["seconds"] = time.perf_counter() - t0
    print(f"[clock] phase 3d (g): step_fn_batch took {out['step_fn_batch']['seconds']:.1f} s")
    return out


def crate_card_vs_cpu():
    """Phases 4 and 6 on the user-built worlds, B=SMALL_B: ``step_batched``
    on the crate pile from ``crate_overlap_state``, split and fused on the
    card against the split step on the CPU, positions after SMALL_STEPS
    steps within CPU_ATOL, and the gradient of ``crate_kick_loss`` through
    them (4 checkpointed segments) within GRAD_RTOL in norm; the mixed and
    area worlds on the split step, from ``kinds_state``.  Those worlds'
    drops and bounces are chaotic (a one-ulp change of the start moves some
    worlds' positions by 1e-2 to 0.3 within 60 steps on the CPU alone), so
    there each step of the card starts from the CPU's state and its
    positions are held within CPU_ATOL, and the free rollouts' distance is
    read with no bar."""
    from parallax_tpu_torch.engine.batched import _from_soa, step_batched
    from torch_scenarios import (KIND_WORLDS, crate_kick_loss, crate_overlap_state, crate_world,
                                 kinds_state, kinds_world)

    res = {}
    for label, dev, fused in (("cpu", "cpu", False), ("split", "cuda", False),
                              ("fused", "cuda", True)):
        w, _ = crate_world(dev, fused=fused)
        s = crate_overlap_state(w, SMALL_B)
        st = _from_soa(s)
        with torch.no_grad():
            for _ in range(SMALL_STEPS):
                st, _ = step_batched(w, st)
        u = torch.zeros(2, device=dev, requires_grad=True)
        loss, _ = crate_kick_loss(w, s, u, SMALL_STEPS, 4)
        (g,) = torch.autograd.grad(loss, u)
        res[label] = (st.pos.cpu(), loss.item(), g.cpu())
    pos_c, loss_c, g_c = res["cpu"]
    for label in ("split", "fused"):
        pos, loss, g = res[label]
        perr = (pos - pos_c).abs().max().item()
        grel = ((g - g_c).norm() / g_c.norm()).item()
        print(f"[check] crate pile step_batched {label} B={SMALL_B} x {SMALL_STEPS} steps, card vs "
              f"CPU: max |pos diff| {perr:.3e}; crate_kick_loss {loss:.9f} vs {loss_c:.9f}, its "
              f"gradient rel diff in norm {grel:.2e}")
        check(torch.isfinite(pos).all().item() and perr <= CPU_ATOL,
              f"crate pile {label}: card vs CPU positions differ by {perr}")
        check(grel <= GRAD_RTOL and g_c.norm() > 0,
              f"crate pile {label}: card vs CPU gradient rel diff {grel}")
    for name in KIND_WORLDS:
        wc, st0c = kinds_world(name, "cpu", use_cuda_solver=True)
        wg, _ = kinds_world(name, "cuda", use_cuda_solver=True)
        sc = kinds_state(name, wc, st0c, SMALL_B)
        st_c, free_g = _from_soa(sc), _from_soa(type(sc)(*(x.cuda() for x in sc)))
        step_err = 0.0
        with torch.no_grad():
            for _ in range(SMALL_STEPS):
                nxt, _ = step_batched(wc, st_c)
                one, _ = step_batched(wg, type(st_c)(*(x.cuda() for x in st_c)))
                step_err = max(step_err, (one.pos.cpu() - nxt.pos).abs().max().item())
                free_g, _ = step_batched(wg, free_g)
                st_c = nxt
        d = (free_g.pos.cpu() - st_c.pos).abs().amax((1, 2))
        print(f"[check] {name} world step_batched split B={SMALL_B} x {SMALL_STEPS} steps, card vs "
              f"CPU: each step from the CPU's state, max |pos diff| {step_err:.3e}; free "
              f"rollouts (a reading): max |pos diff| {d.max().item():.3e}, worlds beyond "
              f"{CPU_ATOL}: {int((d > CPU_ATOL).sum())}")
        check(np.isfinite(step_err) and step_err <= CPU_ATOL,
              f"{name} world: card vs CPU step differs by {step_err}")


def crate_paths(gpu):
    """Phase 5b on the crate pile at B: ``step_batched`` over STEPS steps
    from ``crate_overlap_state``, split, fused, fused, split, each with its
    launches and peak memory; world-steps/s, best of two per path; the
    layers of a step (CUDA events).  Returns ``{path: (world-steps/s,
    (solver, fused launches), peak GiB)}``."""
    from parallax_tpu_torch.engine.batched import (_from_soa, collide_batched, integrate_bm,
                                                   step_batched)
    from parallax_tpu_torch.ops import contact_solver, fused_step
    from torch_scenarios import crate_overlap_state, crate_world

    worlds = {"split": crate_world("cuda")[0], "fused": crate_world("cuda", fused=True)[0]}
    s = crate_overlap_state(worlds["split"], B)
    res = {}
    with torch.no_grad():
        for label in ("split", "fused", "fused", "split"):
            w = worlds[label]
            st = _from_soa(s)
            step_batched(w, st)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            contact_solver.launches = fused_step.launches = 0
            t0 = time.perf_counter()
            for _ in range(STEPS):
                st, con = step_batched(w, st)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = (contact_solver.launches, fused_step.launches)
            want = (STEPS, 0) if label == "split" else (0, STEPS)
            check(counts == want, f"crate pile {label}: launches (solver, fused) {counts}, "
                  f"want {want}")
            check(torch.isfinite(st.pos).all().item() and tuple(con.active.shape) == (88, B),
                  f"crate pile {label}: non-finite state or lanes {tuple(con.active.shape)}")
            peak = torch.cuda.max_memory_allocated() / 2**30
            rate = B * STEPS / sec
            print(f"[main] crate pile step_batched {label} B={B} x {STEPS} steps (14 bodies, "
                  f"C=88): launches solver {counts[0]}, fused {counts[1]}, {rate:.1f} world-steps/s, "
                  f"peak memory {peak:.2f} GiB, on {gpu}")
            if label not in res or rate > res[label][0]:
                res[label] = (rate, counts, peak)
        si, _ = integrate_bm(worlds["split"], s)
        con = collide_batched(worlds["split"], si)
        c = worlds["split"].config
        st = _from_soa(s)
        layers = {
            "split step (step_batched)": lambda: step_batched(worlds["split"], st),
            "fused step (step_batched)": lambda: step_batched(worlds["fused"], st),
            "collide_batched": lambda: collide_batched(worlds["split"], si),
            "solve kernel": lambda: contact_solver.solve_contacts(
                worlds["split"], si, con, c.solver_iterations, c.position_iterations, c.dt,
                c.contact),
            "fused step kernel": lambda: fused_step.physics_core_fused(worlds["fused"], s),
        }
        for name_, fn in layers.items():
            cuda_ms(fn, 2)
            print(f"[time] crate pile: {name_} {cuda_ms(fn, 10):.4f} ms per call at B={B} on {gpu}")
    print(f"[time] crate pile step_batched B={B}: split {res['split'][0]:.1f}, fused "
          f"{res['fused'][0]:.1f} world-steps/s (best of 2 turns each of {STEPS} steps) on {gpu}")
    return res


def crate_train(gpu):
    """Phase 7 on the crate pile: the gradient of ``crate_kick_loss``
    through HORIZON steps of ``step_batched`` at B, SEGMENTS checkpointed
    segments as the train path runs them, split and fused, one timed run
    each after a warm-up.  Returns ``{path: (s, launches, peak)}`` with the
    launches as (solver fwd, bwd, fused fwd, bwd)."""
    from parallax_tpu_torch.ops import contact_solver, fused_step
    from torch_scenarios import crate_kick_loss, crate_overlap_state, crate_world

    res = {}
    for label, fused in (("split", False), ("fused", True)):
        w, _ = crate_world("cuda", fused=fused)
        s = crate_overlap_state(w, B)
        for timed in (False, True):
            u = torch.zeros(2, device="cuda", requires_grad=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            contact_solver.launches = contact_solver.bwd_launches = 0
            fused_step.launches = fused_step.bwd_launches = 0
            t0 = time.perf_counter()
            loss, _ = crate_kick_loss(w, s, u, HORIZON, SEGMENTS)
            (g,) = torch.autograd.grad(loss, u)
            g = g.cpu()  # synchronizes
            sec = time.perf_counter() - t0
        counts = (contact_solver.launches, contact_solver.bwd_launches,
                  fused_step.launches, fused_step.bwd_launches)
        want = (2 * HORIZON, HORIZON, 0, 0) if not fused else (0, 0, 2 * HORIZON, HORIZON)
        check(counts == want, f"crate pile {label} gradient: launches {counts}, want {want}")
        check(bool(torch.isfinite(g).all()) and g.norm() > 0,
              f"crate pile {label} gradient: {g.tolist()}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        res[label] = (sec, counts, peak)
        print(f"[train] crate pile {label} gradient of crate_kick_loss B={B} h={HORIZON} "
              f"segments={SEGMENTS}: loss {loss.item():.6f}, grad {[round(x, 9) for x in g.tolist()]}, "
              f"{sec:.3f} s, {B * HORIZON / sec:.1f} world-steps/s, launches solver fwd {counts[0]} "
              f"bwd {counts[1]}, fused fwd {counts[2]} bwd {counts[3]}, peak memory {peak:.2f} GiB, "
              f"on {gpu}")
    return res


def train_once(env, horizon, segments, states, **step_kw):
    """One timed train step (the 9-32-2 MLP, Adam at 3e-3) from fresh
    weights, ``step_kw`` to ``make_train_step``: ``(seconds, loss, grads,
    kernel counts, peak GiB)``; the counts and the peak start from 0 just
    before the step."""
    from parallax_tpu_torch.parallel import rollout

    params = mlp_params(states.t.device)
    step = rollout.make_train_step(env, mlp, rollout.adam(params, 3e-3), horizon,
                                   checkpoint_segments=segments, **step_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    params, _, m = step(params, states)
    loss = m["loss"].item()  # synchronizes
    sec = time.perf_counter() - t0
    grads = [p.grad.detach().clone() for p in params.values()]
    return sec, loss, grads, kernel_counts(), torch.cuda.max_memory_allocated() / 2**30


FLEET_CHUNK = 4096  # phase 8: two waves of the B=8192 fleet
FLEET_FUSED_H = 12  # phase 8: the fused train step's horizon


def tree_equal(a, b):
    """Every tensor leaf of two trees equal to the bit."""
    from parallax_tpu_torch.utils.pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def kernel_counts():
    from parallax_tpu_torch.ops import contact_solver, fused_step

    return (contact_solver.launches, contact_solver.bwd_launches,
            fused_step.launches, fused_step.bwd_launches)


def zero_counts():
    from parallax_tpu_torch.ops import contact_solver, fused_step

    contact_solver.launches = contact_solver.bwd_launches = 0
    fused_step.launches = fused_step.bwd_launches = 0


def fleet_train(env, mesh, horizon, segments, states):
    """One train step on ``mesh`` or without one (None), in waves of
    FLEET_CHUNK (:func:`train_once`): ``(seconds, loss, grads, kernel
    counts, collectives)``."""
    from torch_fleet_worker import counting_collectives

    with counting_collectives() as coll:
        sec, loss, grads, counts, _ = train_once(env, horizon, segments, states,
                                                 max_chunk=FLEET_CHUNK, mesh=mesh)
    return sec, loss, grads, counts, dict(coll)


def fleet_rank(rank, port, out_dir):
    """Phase 8 (ii): one of two gloo ranks on the one card; its block of
    the B=8192 fleet, one split train step of SMALL_H steps."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from parallax_tpu_torch.envs.lunar_lander import LunarLander
    from parallax_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    pmesh.distributed_init(f"tcp://127.0.0.1:{port}", world_size=2, rank=rank,
                           backend="gloo", device="cuda")
    try:
        mesh = pmesh.make_world_mesh("cuda")
        env = LunarLander(device="cuda")
        states = env.reset_fn_batch(pmesh.shard_batch(keys_for(B, 9, "cuda"), mesh))
        sec, loss, grads, counts, coll = fleet_train(env, mesh, SMALL_H, 2, states)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), sec=sec, loss=loss,
                 counts=np.array(counts), all_reduce=coll["all_reduce"],
                 **{f"g{i}": g.cpu().numpy() for i, g in enumerate(grads)})
    finally:
        torch.distributed.destroy_process_group()


def fleet_phase(gpu):
    """Phase 8, the fleet (``parallel/mesh.py``, the mesh path of the
    rollouts and the train step, ``parallel/dryrun.py``):

    (i) a one-rank NCCL mesh on the card at B=8192, ``max_chunk=4096`` (2
    waves): the split lander's ``rollout_batch(mesh=)`` over 100 steps, its
    train step over 100 steps in 4 segments and the fused lander's train
    step over 12 steps, each bitwise equal to the same call without a mesh,
    with the kernels' launches and the collectives counted (none in the
    rollout, one all-reduce a train step);
    (ii) two gloo ranks on the one card, each with 4096 of the same 8192
    worlds: a split train step of 12 steps within LOSS_RTOL/GRAD_RTOL of
    the one-process step at B=8192, bitwise equal across the ranks;
    (iii) ``dryrun_multichip`` on the NCCL mesh.
    Returns each kernel's launches on the mesh path (not the runs without
    a mesh they are compared with)."""
    import socket

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
    from parallax_tpu_torch.parallel import mesh as pmesh
    from parallax_tpu_torch.parallel.dryrun import dryrun_multichip
    from torch_fleet_worker import counting_collectives

    dev = torch.device("cuda")
    mesh = pmesh.make_world_mesh("cuda")
    check(dist.get_backend() == "nccl" and mesh.size(0) == 1,
          f"one-rank mesh: backend {dist.get_backend()}, size {mesh.size(0)}")
    fleet = np.zeros(4, np.int64)  # the mesh path's launches: solver fwd, bwd, fused fwd, bwd

    # (i) the rollout
    env = LunarLander(device=dev)
    params = policy_params(dev)
    states = env.reset_fn_batch(keys_for(B, 8, dev))
    runs = {}
    for label, m in (("mesh", mesh), ("plain", None)):
        torch.cuda.synchronize()
        zero_counts()
        with counting_collectives() as coll:
            t0 = time.perf_counter()
            out = env.rollout_batch(states, policy, STEPS, params, max_chunk=FLEET_CHUNK, mesh=m)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        runs[label] = (out, sec, kernel_counts(), sum(coll.values()))
    (out_m, roll_s, counts_m, coll_m), (out_p, roll_plain_s, _, _) = runs["mesh"], runs["plain"]
    check(tree_equal(out_m, out_p), "fleet rollout: the one-rank NCCL mesh differs from no mesh")
    check(counts_m == (2 * STEPS, 0, 0, 0), f"fleet rollout: launches {counts_m}, "
          f"want {(2 * STEPS, 0, 0, 0)} (2 waves x {STEPS} steps)")
    check(coll_m == 0, f"fleet rollout: {coll_m} collectives")
    check(torch.isfinite(out_m[1].obs).all().item(), "fleet rollout: non-finite obs")
    fleet += counts_m
    print(f"[fleet] rollout_batch B={B} x {STEPS} steps, max_chunk={FLEET_CHUNK}, one-rank "
          f"NCCL mesh: bitwise equal to no mesh, solver launches {counts_m[0]}, collectives 0; "
          f"{roll_s:.3f} s (no mesh {roll_plain_s:.3f} s) on {gpu}")

    # (i) the split and fused train steps
    env_f = LunarLander(LanderConfig(broadphase=False, use_cuda_fused=True), device=dev)
    train = {}
    for label, e, h, seg, want in (
        ("split", env, HORIZON, SEGMENTS, (4 * HORIZON, 2 * HORIZON, 0, 0)),
        ("fused", env_f, FLEET_FUSED_H, 2, (0, 0, 4 * FLEET_FUSED_H, 2 * FLEET_FUSED_H)),
    ):
        st = e.reset_fn_batch(keys_for(B, 7, dev))
        sec_p, loss_p, g_p, _, _ = fleet_train(e, None, h, seg, st)
        sec_m, loss_m, g_m, counts, coll = fleet_train(e, mesh, h, seg, st)
        check(np.isfinite(loss_m), f"fleet {label} train step: non-finite loss")
        check(loss_m == loss_p and all(torch.equal(a, b) for a, b in zip(g_m, g_p)),
              f"fleet {label} train step: the one-rank NCCL mesh's loss or gradients differ "
              f"from no mesh ({loss_m} vs {loss_p})")
        check(counts == want, f"fleet {label} train step: launches (solver fwd, bwd, fused fwd, "
              f"bwd) {counts}, want {want} (2 waves x {h} steps, forward and recompute)")
        check(coll["all_reduce"] == 1 and sum(coll.values()) == 1,
              f"fleet {label} train step: collectives {coll}, want one all_reduce")
        fleet += counts
        train[label] = {"s": sec_m, "plain_s": sec_p, "loss": loss_m}
        print(f"[fleet] {label} train step B={B} h={h} segments={seg} max_chunk={FLEET_CHUNK}, "
              f"one-rank NCCL mesh: loss {loss_m:.6f}, loss and gradients bitwise equal to no "
              f"mesh, launches {counts}, one all_reduce; {sec_m:.3f} s (no mesh {sec_p:.3f} s) "
              f"on {gpu}")

    # the train step's one collective alone: the all-reduce of its bucket
    # (the 9-32-2 MLP's 386 gradients, the loss and the return)
    bucket = torch.ones(388, device=dev)
    for _ in range(10):
        dist.all_reduce(bucket)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        dist.all_reduce(bucket)
    torch.cuda.synchronize()
    all_reduce_ms = (time.perf_counter() - t0) * 10.0
    print(f"[fleet] all_reduce of the train step's 388-float bucket on the one-rank NCCL "
          f"group: {all_reduce_ms:.4f} ms a call (host clock, 100 calls) on {gpu}")

    # (ii) two gloo ranks on the one card against the one-process step
    st = env.reset_fn_batch(keys_for(B, 9, dev))
    _, loss_1, g_1, _, _ = fleet_train(env, None, SMALL_H, 2, st)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "fleet")
    os.makedirs(out_dir, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    mp.start_processes(fleet_rank, args=(port, out_dir), nprocs=2, join=True,
                       start_method="spawn")
    sec_2 = time.perf_counter() - t0
    ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(2)]
    for k in ranks[0]:
        if k not in ("sec",):
            check(np.array_equal(ranks[0][k], ranks[1][k]), f"fleet 2 ranks: {k} differs")
    for r in ranks:
        check(tuple(r["counts"]) == (2 * SMALL_H, SMALL_H, 0, 0) and int(r["all_reduce"]) == 1,
              f"fleet 2 ranks: launches {r['counts']}, all_reduce {r['all_reduce']}")
    loss_2 = float(ranks[0]["loss"])
    loss_rel = abs(loss_2 - loss_1) / abs(loss_1)
    grad_rel = max(np.linalg.norm(ranks[0][f"g{i}"] - g.cpu().numpy())
                   / np.linalg.norm(g.cpu().numpy()) for i, g in enumerate(g_1))
    check(loss_rel <= LOSS_RTOL, f"fleet 2 ranks: loss rel diff {loss_rel} to one process")
    check(grad_rel <= GRAD_RTOL, f"fleet 2 ranks: gradient rel diff {grad_rel} to one process")
    fleet += sum(np.asarray(r["counts"]) for r in ranks)
    print(f"[fleet] 2 gloo ranks on one card, {B // 2} worlds each, split train step h={SMALL_H}: "
          f"loss {loss_2:.7f} vs one process {loss_1:.7f} (rel {loss_rel:.2e}), gradients max "
          f"rel diff in norm {grad_rel:.2e}, the ranks bitwise equal; rank step "
          f"{float(ranks[0]['sec']):.3f} s, spawn to join {sec_2:.1f} s on {gpu}")

    # (iii) the dry run on the NCCL mesh
    t0 = time.perf_counter()
    dry = dryrun_multichip(mesh)
    print(f"[fleet] dryrun_multichip on the one-rank NCCL mesh: {dry}, "
          f"{time.perf_counter() - t0:.2f} s on {gpu}")
    dist.destroy_process_group()
    return {"launches": [int(x) for x in fleet], "train": train, "rollout_s": roll_s,
            "rollout_plain_s": roll_plain_s, "all_reduce_ms": all_reduce_ms,
            "two_ranks_s": sec_2}


OPT_STEPS = 60  # phase 9 (i): candidate lander step by step against the full table
POS_ATOL, VEL_ATOL = 1e-5, 1e-4  # the JAX package's candidate test's bars
ROLLED_ATOL = 2e-5  # rolled against the lane engine: tests/test_rolled.py's bar
REMAT_RTOL = 1e-6  # the remat leg's loss and gradients against the plain one
# rolled billiards48 card against CPU: some 19,000 small ops a step on
# either side, so its depth is cut to keep the script's time
ROLLED48_CPU_STEPS = 20


def remat_leg(out):
    """Phase 9 (iii) in a process of its own, started with
    ``PARALLAX_REMAT_COLLIDE=1``: the lander's split train step at B
    (HORIZON steps, SEGMENTS segments) after a short warm-up (the script's
    own leg runs warm, after phase 7), written to ``out``."""
    from parallax_tpu_torch.engine import batched
    from parallax_tpu_torch.envs.lunar_lander import LunarLander
    from parallax_tpu_torch.ops import _build

    check(batched._REMAT_COLLIDE, "remat leg: PARALLAX_REMAT_COLLIDE is not set")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.load()
    env = LunarLander()
    states = env.reset_fn_batch(keys_for(B, 7, "cuda"))
    train_once(env, SEGMENTS, SEGMENTS, states)  # warm-up: one step a segment
    sec, loss, grads, counts, peak = train_once(env, HORIZON, SEGMENTS, states)
    np.savez(out, sec=sec, loss=loss, counts=np.array(counts), peak=peak,
             **{f"g{i}": g.cpu().numpy() for i, g in enumerate(grads)})


def options_phase(gpu):
    """Phase 9: three options of the JAX package, each against its reference.

    (i) ``LanderConfig(terrain_candidates=True)`` at B: the candidate world
    (28 lanes where the full table has 48; 11 gathered terrain windows)
    step by step against the full-table lander from the scattered fleet of
    the JAX package's test, split and fused (positions within POS_ATOL,
    velocities within VEL_ATOL, leg flags equal); its 100-step rollouts
    timed in turns with the full table's, with device kernels a step; the
    four kernels on the candidate world's contact scenario against their
    plain versions at phase 3's bars, timed, with their bounds; its split
    and fused train steps card against CPU at SMALL_B (h=SMALL_H).
    (ii) ``BilliardsConfig(rolled=True)`` (``engine/rolled.py``, plain
    torch) with 7 and 47 object balls: 50-step rollouts at B beside the
    lane engine's, with device kernels a step and peak memory; one step
    against the lane engine from the scattered table (ROLLED_ATOL); card
    against CPU at SMALL_B over SMALL_STEPS steps (billiards48:
    ROLLED48_CPU_STEPS), at phase 4's bars.
    (iii) ``PARALLAX_REMAT_COLLIDE``: the lander's split train step at B
    (HORIZON, SEGMENTS) here and in a process started with the switch
    set: loss and gradients within REMAT_RTOL, peak memory and time of
    each.  Returns the kernels' entries for the candidate world and the
    phase's readings."""
    from parallax_tpu_torch.engine import rolled
    from parallax_tpu_torch.engine.batched import _to_soa, collide_batched, physics_core
    from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
    from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
    from parallax_tpu_torch.ops import contact_solver, fused_step
    from parallax_tpu_torch.parallel import rollout
    from parallax_tpu_torch.utils.pytree import tree_map
    from torch_scenarios import billiards_scatter, candidate_contact_case, lander_scatter_state

    dev = torch.device("cuda")
    out = {"kernels": {}, "launches": np.zeros(4, np.int64)}
    cand = LanderConfig(terrain_candidates=True)
    cand_f = LanderConfig(terrain_candidates=True, broadphase=False, use_cuda_fused=True)
    envs = {
        "split": (LunarLander(), LunarLander(cand)),
        "fused": (LunarLander(LanderConfig(broadphase=False, use_cuda_fused=True)),
                  LunarLander(cand_f)),
    }
    wc, wf = envs["split"][1]._bm_world, envs["fused"][1]._bm_world
    C, C_full = wc.table.n_contacts, envs["split"][0].world.table.n_contacts
    check(C == 28 and C_full == 48, f"candidate world C={C}, full table C={C_full}")

    # (i) step by step against the full table, from the scattered fleet
    acts = torch.zeros((B, 2), device=dev)
    for label, (full, e) in envs.items():
        st = lander_scatter_state(e, B)
        pos_err = vel_err = 0.0
        legs = 0
        for _ in range(OPT_STEPS):
            sc, tc = e.step_batch(st, acts)
            sf, tf = full.step_batch(st, acts)
            pos_err = max(pos_err, (sc.bodies.pos - sf.bodies.pos).abs().max().item())
            vel_err = max(vel_err, (sc.bodies.vel - sf.bodies.vel).abs().max().item())
            check(torch.equal(sc.leg_contacts, sf.leg_contacts)
                  and torch.equal(tc.terminated, tf.terminated),
                  f"candidate {label}: leg or termination flags differ from the full table")
            legs += int(sc.leg_contacts.sum())
            st = sc
        print(f"[options] candidate lander {label}, B={B}, {OPT_STEPS} steps from the scattered "
              f"fleet, each from the same state: max |pos diff| {pos_err:.3e}, max |vel diff| "
              f"{vel_err:.3e} against the full table, flags equal ({legs} leg-contact flags)")
        check(np.isfinite(pos_err) and pos_err <= POS_ATOL and vel_err <= VEL_ATOL,
              f"candidate {label}: pos {pos_err} / vel {vel_err} beyond {POS_ATOL} / {VEL_ATOL}")
        check(legs > 0, f"candidate {label}: no leg touched the ground")

    t_phase = time.perf_counter()

    def lap(label):
        print(f"[clock] phase 9: {label} at {time.perf_counter() - t_phase:.1f} s into the phase")

    lap("the 100-step rollouts start")
    # (i) 100-step rollouts in turns: full, candidates, candidates, full
    params = policy_params(dev)
    start = lowered(envs["split"][0].reset_fn_batch(keys_for(B, 5, dev)), dev)
    rolls = {}
    for label, (full, e) in envs.items():
        want = (STEPS, 0, 0, 0) if label == "split" else (0, 0, STEPS, 0)
        secs = {"full": [], "candidates": []}
        for which in ("full", "candidates", "candidates", "full"):
            env_ = full if which == "full" else e
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            _, tr = env_.rollout_batch(start, policy, STEPS, params)
            torch.cuda.synchronize()
            secs[which].append(time.perf_counter() - t0)
            check(kernel_counts() == want, f"{label} {which} rollout: launches {kernel_counts()}, "
                  f"want {want}")
            check(torch.isfinite(tr.obs).all().item(), f"{label} {which} rollout: non-finite obs")
            if which == "candidates":
                out["launches"] += kernel_counts()
        ps = e._to_planes(start)
        a0 = policy(params, e.plane_obs(ps.s, ps.aux))
        kern = {w: device_kernels(lambda: env_._step_planes(env_._to_planes(start), a0))
                for w, env_ in (("full", full), ("candidates", e))}
        rolls[label] = {w: {"s": min(v), "env_steps_per_s": B * STEPS / min(v),
                            "device_kernels_a_step": kern[w][0], "device_ms_a_step": kern[w][1]}
                        for w, v in secs.items()}
        print(f"[options] {label} rollout B={B} x {STEPS} steps, in turns: full table (C={C_full}) "
              f"{[round(x, 3) for x in secs['full']]} s, candidates (C={C}) "
              f"{[round(x, 3) for x in secs['candidates']]} s; a step's device kernels full "
              f"{kern['full'][0]} ({kern['full'][1]:.3f} ms), candidates {kern['candidates'][0]} "
              f"({kern['candidates'][1]:.3f} ms) on {gpu}")

    lap("the candidate world's kernels start")
    # (i) the four kernels on the candidate world's contact scenario
    e_s, e_f = envs["split"][1], envs["fused"][1]
    cfg = wc.config
    s, ov = candidate_contact_case(e_s, B, dev)
    check(len(ov) == 11, f"candidate override has {len(ov)} parts")
    con = collide_batched(wc, s, ov)
    n_active = int(con.active.sum())
    check(n_active > 100, f"candidate scenario has {n_active} active lanes")
    args = (cfg.solver_iterations, cfg.position_iterations, cfg.dt, cfg.contact)
    cot = type(s)(*(torch.from_numpy(np.random.default_rng(5).standard_normal(
        (wc.n_bodies, B)).astype(np.float32)).to(dev) for _ in range(6)))
    got = contact_solver.solve_contacts(wc, s, con, *args)
    want = contact_solver.solve_contacts_plain(wc, s, con, *args)
    gb = contact_solver.solve_contacts_bwd(wc, s, con, cot, *args)
    wb = contact_solver.solve_contacts_bwd_plain(wc, s, con, cot, *args)
    fs, fc = fused_step.physics_core_fused(wf, s, ov)
    ps_, pc = fused_step.fused_step_plain(wf, s, ov)
    fgb = fused_step.fused_step_bwd(wf, s, ov, cot)
    fwb = fused_step.fused_step_bwd_plain(wf, s, ov, cot)
    torch.cuda.synchronize()
    f_active = int(pc.active.sum())
    check(torch.equal(fc.active, pc.active), "candidate fused kernel: active flags differ")
    errs = {
        "contact_solve_fwd": planes_err("candidate solve kernel vs plain", got, want),
        "contact_solve_bwd": hold_vjp("candidate solve reverse pass vs plain VJP",
                                      (*gb[0], *gb[1:]), (*wb[0], *wb[1:]))[0],
        "fused_step_fwd": planes_err("candidate fused kernel vs plain", fs, ps_),
        "fused_step_bwd": hold_vjp("candidate fused reverse pass vs plain VJP",
                                   (*fgb[0], *fgb[1:]), (*fwb[0], *fwb[1:]))[0],
    }
    check(all(x.abs().max().item() > 0 for x in fgb[0]), "candidate fused reverse pass: dead plane")
    timed = {
        "contact_solve_fwd": (lambda: contact_solver.solve_contacts(wc, s, con, *args),
                              lambda: contact_solver.solve_contacts_plain(wc, s, con, *args), 20),
        "contact_solve_bwd": (
            lambda: contact_solver.solve_contacts_bwd(wc, s, con, cot, *args),
            lambda: contact_solver.solve_contacts_bwd_plain(wc, s, con, cot, *args), 10),
        "fused_step_fwd": (lambda: fused_step.physics_core_fused(wf, s, ov),
                           lambda: fused_step.fused_step_plain(wf, s, ov), 20),
        "fused_step_bwd": (lambda: fused_step.fused_step_bwd(wf, s, ov, cot),
                           lambda: fused_step.fused_step_bwd_plain(wf, s, ov, cot), 5),
    }
    counts = (n_active, B, C, wc.n_bodies, wc.joints.n_joints, cfg.solver_iterations,
              cfg.position_iterations)
    touched = touched_pairs(wf, pc.active)
    bounds = {
        "contact_solve_fwd": solver_bound_ms(*counts, bwd=False),
        "contact_solve_bwd": solver_bound_ms(*counts, bwd=True),
        "fused_step_fwd": fused_bound_ms(wf, sorted(ov), f_active, B)[:2],
        "fused_step_bwd": fused_bwd_bound_ms(wf, sorted(ov), f_active, touched, B)[:2],
    }
    for k, (fn, plain, reps) in timed.items():
        ms, plain_ms, t = turns(fn, plain, reps)
        out["kernels"][k] = {"max_abs_err": errs[k], "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bounds[k][0], "bound_by": bounds[k][1]}
        print(f"[kernel] {k} on the candidate world (C={C}, {len(ov)} override parts) at B={B}: "
              f"{n_active if k.startswith('contact') else f_active} active lanes, max |diff| "
              f"{errs[k]:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (turns "
              f"{[round(x, 4) for x in t]}), bound {bounds[k][0]:.5f} ms ({bounds[k][1]}) on {gpu}")

    lap("the candidate train steps start")
    # (i) the candidate train steps, card against CPU, from the contact state
    st = lowered(e_s.reset_fn_batch(keys_for(SMALL_B, 6, dev)), dev)
    st, _ = e_s.rollout_batch(st, zero_policy, 40)
    cpu_st = tree_map(lambda x: x.cpu(), st)
    p = mlp_params("cpu")
    loss_c, _ = rollout.make_loss_fn(LunarLander(cand, device="cpu"), mlp, SMALL_H, 2)(p, cpu_st)
    grads_c = torch.autograd.grad(loss_c, list(p.values()))
    train = {}
    for label, e, want in (("split", e_s, (2 * SMALL_H, SMALL_H, 0, 0)),
                           ("fused", e_f, (0, 0, 2 * SMALL_H, SMALL_H))):
        p = mlp_params(dev)
        zero_counts()
        loss, _ = rollout.make_loss_fn(e, mlp, SMALL_H, 2)(p, tree_map(lambda x: x.to(dev), cpu_st))
        grads = torch.autograd.grad(loss, list(p.values()))
        check(kernel_counts() == want, f"candidate {label} train: launches {kernel_counts()}, "
              f"want {want}")
        out["launches"] += kernel_counts()
        loss_rel = abs(loss.item() - loss_c.item()) / abs(loss_c.item())
        grad_rel = max((a.cpu() - b).norm().item() / b.norm().item()
                       for a, b in zip(grads, grads_c))
        train[label] = {"loss_rel": loss_rel, "grad_rel": grad_rel}
        print(f"[check] candidate {label} train loss+grads B={SMALL_B} h={SMALL_H}, card vs CPU: "
              f"loss {loss.item():.7f} vs {loss_c.item():.7f} (rel {loss_rel:.2e}), grads max rel "
              f"diff in norm {grad_rel:.2e}; launches {kernel_counts()}")
        check(loss_rel <= LOSS_RTOL and grad_rel <= GRAD_RTOL,
              f"candidate {label} train: card vs CPU loss {loss_rel} / grads {grad_rel}")
        check(all(g.norm().item() > 0 for g in grads), f"candidate {label} train: a zero gradient")
    out["candidates"] = {"C": C, "C_full": C_full, "override_parts": len(ov), "rollouts": rolls,
                         "train": train}

    lap("rolled billiards starts")
    # (ii) rolled billiards
    rolled_out = {}
    for n_obj in (7, 47):
        lane, rl = Billiards(BilliardsConfig(n_object=n_obj)), Billiards(
            BilliardsConfig(n_object=n_obj, rolled=True))
        s0 = billiards_scatter(rl, B, n_obj)
        want_s, _ = physics_core(lane.world, s0)
        got_s, _ = rolled.physics_rolled(rl._rolled_world, s0)
        torch.cuda.synchronize()
        err = planes_err(f"rolled billiards{n_obj + 1} vs lane engine", got_s, want_s,
                         bar=ROLLED_ATOL)
        row = {"one_step_max_abs_err": err}
        cp = circle_params(rl.observation_size, dev)
        st = billiards_start(rl, keys_for(B, 8, dev))
        for label, e in (("lane", lane), ("rolled", rl)):
            e.rollout_batch(st, circle_policy, 2, cp)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
            t0 = time.perf_counter()
            _, tr = e.rollout_batch(st, circle_policy, CIRCLE_STEPS, cp)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            counts = kernel_counts()
            want = (CIRCLE_STEPS, 0, 0, 0) if label == "lane" else (0, 0, 0, 0)
            check(counts == want, f"billiards{n_obj + 1} {label}: launches {counts}, want {want}")
            check(torch.isfinite(tr.obs).all().item(), f"billiards{n_obj + 1} {label}: non-finite")
            ps = e._to_planes(st)
            a0 = circle_policy(cp, e.plane_obs(ps.s, ps.aux))
            kern = device_kernels(lambda: e._step_planes(e._to_planes(st), a0))
            row[label] = {"env_steps_per_s": B * CIRCLE_STEPS / sec, "s": sec, "peak_gib": peak,
                          "device_kernels_a_step": kern[0], "device_ms_a_step": kern[1]}
            del tr, ps
        small, cpu_steps = {}, SMALL_STEPS if n_obj == 7 else ROLLED48_CPU_STEPS
        for d in ("cuda", "cpu"):
            e = Billiards(BilliardsConfig(n_object=n_obj, rolled=True), device=d)
            _, small[d] = e.rollout_batch(billiards_start(e, keys_for(SMALL_B, 4, d)),
                                          circle_policy, cpu_steps,
                                          circle_params(e.observation_size, d))
        g, c = small["cuda"], small["cpu"]
        obs_err = (g.obs.cpu() - c.obs).abs().max().item()
        rew_err = (g.reward.cpu() - c.reward).abs().max().item()
        done_share = (g.done.cpu() == c.done).all(0).double().mean().item()
        row["card_vs_cpu"] = {"steps": cpu_steps, "obs": obs_err, "reward": rew_err,
                              "done_share": done_share}
        rolled_out[f"billiards{n_obj + 1}"] = row
        print(f"[options] rolled billiards{n_obj + 1} ({rl.n_balls} balls, "
              f"{len(rl._rolled_world.offsets)} offsets + 4 walls): one step vs the lane engine "
              f"(C={lane.world.table.n_contacts}) max |diff| {err:.3e}; B={B} x {CIRCLE_STEPS} "
              f"steps lane {row['lane']['env_steps_per_s']:.1f} env-steps/s "
              f"({row['lane']['device_kernels_a_step']} device kernels a step, peak "
              f"{row['lane']['peak_gib']:.2f} GiB), rolled {row['rolled']['env_steps_per_s']:.1f} "
              f"({row['rolled']['device_kernels_a_step']} device kernels a step, "
              f"{row['rolled']['device_ms_a_step']:.3f} ms device time, peak "
              f"{row['rolled']['peak_gib']:.2f} GiB); card vs CPU B={SMALL_B} x {cpu_steps}: "
              f"obs {obs_err:.3e}, reward {rew_err:.3e}, equal done sequences {done_share:.4f} "
              f"on {gpu}")
        check(obs_err <= CPU_ATOL and rew_err <= CPU_ATOL and done_share >= CPU_DONE_SHARE,
              f"rolled billiards{n_obj + 1}: card vs CPU obs {obs_err}, reward {rew_err}, "
              f"done share {done_share}")
        del lane, rl
    out["rolled"] = rolled_out

    lap("the remat switch starts")
    # (iii) the remat switch: the split train step here and in a process
    # started with PARALLAX_REMAT_COLLIDE=1
    from parallax_tpu_torch.engine import batched

    check(not batched._REMAT_COLLIDE, "the script must run without PARALLAX_REMAT_COLLIDE")
    env = envs["split"][0]
    states = env.reset_fn_batch(keys_for(B, 7, dev))
    sec, loss, grads, counts, peak = train_once(env, HORIZON, SEGMENTS, states)
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "build", "remat_leg.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {here!r}); import chip_smoke; "
         f"chip_smoke.remat_leg({path!r})"],
        cwd=here, env={**os.environ, "PARALLAX_REMAT_COLLIDE": "1"}, timeout=600,
    )
    leg_s = time.perf_counter() - t0
    check(res.returncode == 0, f"remat leg exited {res.returncode}")
    leg = dict(np.load(path))
    loss_rel = abs(float(leg["loss"]) - loss) / abs(loss)
    grad_rel = max(float(np.linalg.norm(leg[f"g{i}"] - g.cpu().numpy())
                         / np.linalg.norm(g.cpu().numpy())) for i, g in enumerate(grads))
    check(tuple(leg["counts"]) == counts == (2 * HORIZON, HORIZON, 0, 0),
          f"remat: launches {tuple(leg['counts'])} and {counts}")
    out["remat_launches"] = np.asarray(counts) + leg["counts"]
    out["remat"] = {"s": sec, "peak_gib": peak, "remat_s": float(leg["sec"]),
                    "remat_peak_gib": float(leg["peak"]), "loss_rel": loss_rel,
                    "grad_rel": grad_rel, "leg_process_s": leg_s}
    print(f"[options] lander split train step B={B} h={HORIZON} segments={SEGMENTS}: without "
          f"the remat switch {sec:.3f} s, peak {peak:.2f} GiB; with PARALLAX_REMAT_COLLIDE=1 "
          f"{float(leg['sec']):.3f} s, peak {float(leg['peak']):.2f} GiB (its process "
          f"{leg_s:.1f} s); loss rel diff {loss_rel:.2e}, gradients max rel diff in norm "
          f"{grad_rel:.2e}; launches {counts} in each on {gpu}")
    check(loss_rel <= REMAT_RTOL and grad_rel <= REMAT_RTOL,
          f"remat: loss {loss_rel} / gradients {grad_rel} beyond {REMAT_RTOL}")
    return out


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
        max_err = max(max_err, planes_err(
            f"kernel vs plain (position_iterations={pi})", got, want))
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
    fused_err = planes_err("fused kernel vs plain", got_s, want_s)
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
    b_err = planes_err("fused cc/cb lanes vs plain", got_s, want_s)
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
    lap("phase 3 on the crate pile starts")
    crates = crate_kernels(gpu)
    lap("phase 3 on the kernels' launch plan starts")
    plans = launch_plans(gpu)
    lap("phase 3 on the worlds past the old part and body limits starts")
    large = large_worlds(gpu)

    lap("phase 3b (the geometry layer, World.detect_contacts) starts")
    print("[geometry] " + json.dumps(detect_contacts_phase(gpu)))

    lap("phase 3c (the per-world step, World.step) starts")
    print("[world.step] " + json.dumps(world_step_phase(gpu)))

    lap("phase 3d (the per-world env API) starts")
    print("[env-api] " + json.dumps(env_api_phase(gpu)))

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
    lap("phase 5b on the crate pile starts")
    crate_rates = crate_paths(gpu)

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
    lap("phases 4 and 6 on the user-built worlds start")
    crate_card_vs_cpu()

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
    lap("phase 7 on the crate pile starts")
    crate_grad = crate_train(gpu)
    lap("phase 8 (the fleet) starts")
    fleet = fleet_phase(gpu)
    print("[fleet] " + json.dumps(fleet))
    lap("phase 9 (the options) starts")
    opts = options_phase(gpu)
    print("[options] " + json.dumps({k: opts[k] for k in ("candidates", "rolled", "remat")}))
    # each kernel on the candidate lander's path (its rollouts and train
    # steps), and rows 1 and 2 on the remat switch's two train steps
    cand = {k: {"launches": int(n), **opts["kernels"][k]}
            for k, n in zip(("contact_solve_fwd", "contact_solve_bwd", "fused_step_fwd",
                             "fused_step_bwd"), opts["launches"])}
    remat = [int(x) for x in opts["remat_launches"]]
    lap("done")
    print(json.dumps({"kernels": [
        {
            "name": "contact_solve_fwd",
            "route": "cuda",
            "source": "parallax_tpu_torch/csrc/contact_solver.cu",
            "replaces": "parallax_tpu/ops/pallas_solver.py:581",
            # the lander's rollout, the circle worlds' split rollouts and
            # the crate pile's split step_batched
            "launches": launches + sum(circle[f"{k} split"][1][0] for k in solves)
            + rc_paths["robocup split"][1][0] + crate_rates["split"][1][0] + fleet["launches"][0]
            + cand["contact_solve_fwd"]["launches"] + remat[0],
            "max_abs_err": max(max_err, large["billiards61"]["solve"]["max_abs_err"],
                               cand["contact_solve_fwd"]["max_abs_err"]),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": fwd_bound,
            "bound_by": fwd_by,
            "library_ms": None,
            **{k: {"launches": circle[f"{k} split"][1][0], **v} for k, v in solves.items()},
            "robocup": {"launches": rc_paths["robocup split"][1][0], **rc["solve"]},
            "crates": {"launches": crate_rates["split"][1][0], **crates["crates"]["solve"]},
            "mixed": crates["mixed"]["solve"],
            "billiards61": large["billiards61"]["solve"],
            "fleet": {"launches": fleet["launches"][0]},
            "candidates": cand["contact_solve_fwd"],
            "remat": {"launches": remat[0]},
            **plans["contact_solve_fwd"],
        },
        {
            "name": "contact_solve_bwd",
            "route": "cuda",
            "source": "parallax_tpu_torch/csrc/contact_solver_bwd.cu",
            "replaces": "parallax_tpu/ops/pallas_solver.py:534",
            # the lander's and RoboCup's split train steps and the crate
            # pile's split gradient
            "launches": train["split"][1][1] + rc_train["robocup split"][1][1]
            + crate_grad["split"][1][1] + fleet["launches"][1]
            + cand["contact_solve_bwd"]["launches"] + remat[1],
            "max_abs_err": max(bwd_err, rc["solve_bwd"]["max_abs_err"],
                               crates["crates"]["solve_bwd"]["max_abs_err"],
                               large["billiards61"]["solve_bwd"]["max_abs_err"],
                               cand["contact_solve_bwd"]["max_abs_err"]),
            "ms": bwd_ms,
            "plain_ms": bwd_plain_ms,
            "bound_ms": bwd_bound,
            "bound_by": bwd_by,
            "library_ms": None,
            "robocup": {"launches": rc_train["robocup split"][1][1], **rc["solve_bwd"]},
            "crates": {"launches": crate_grad["split"][1][1], **crates["crates"]["solve_bwd"]},
            # a reading on random drops: no bar (see crate_kernels)
            "mixed": crates["mixed"]["solve_bwd"],
            "billiards61": large["billiards61"]["solve_bwd"],
            "fleet": {"launches": fleet["launches"][1]},
            "candidates": cand["contact_solve_bwd"],
            "remat": {"launches": remat[1]},
            **plans["contact_solve_bwd"],
        },
        {
            "name": "fused_step_fwd",
            "route": "cuda",
            "source": "parallax_tpu_torch/csrc/fused_step.cu",
            "replaces": "parallax_tpu/ops/pallas_step.py:473",
            "lanes": ["pp", "cc", "cb", "bb", "area_cb"],
            # the lander's fused rollout (pp), billiards8's (cc, cb),
            # RoboCup's (cc, cb, area_cb) and the crate pile's (bb, cb, cc)
            "launches": fused_launches + circle["billiards8 fused"][1][1]
            + rc_paths["robocup fused"][1][1] + crate_rates["fused"][1][1]
            + circle["billiards48 fused"][1][1] + fleet["launches"][2]
            + cand["fused_step_fwd"]["launches"],
            "max_abs_err": max([fused_err, rc["fwd"]["max_abs_err"], crates["fwd"]["max_abs_err"],
                                cand["fused_step_fwd"]["max_abs_err"]]
                               + [v["fwd"]["max_abs_err"] for v in large.values()]),
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
            "crates": {"launches": crate_rates["fused"][1][1], **crates["fwd"]},
            "billiards48": {"launches": circle["billiards48 fused"][1][1],
                            **large["billiards48"]["fwd"]},
            "billiards61": large["billiards61"]["fwd"],
            "override": large["override"]["fwd"],
            "fleet": {"launches": fleet["launches"][2]},
            "candidates": cand["fused_step_fwd"],
            **plans["fused_step_fwd"],
        },
        {
            "name": "fused_step_bwd",
            "route": "cuda",
            "source": "parallax_tpu_torch/csrc/fused_step_bwd.cu",
            "replaces": "parallax_tpu/ops/pallas_step.py:495",
            "lanes": ["pp", "cc", "cb", "bb", "area_cb"],
            # the fused train steps of the lander and RoboCup, billiards8's
            # cue objective and the crate pile's fused gradient
            "launches": train["fused"][1][3] + rc_train["robocup fused"][1][3]
            + rc_train["billiards8 fused cue objective"][1][3] + crate_grad["fused"][1][3]
            + large["billiards48"]["bwd"]["launches"] + fleet["launches"][3]
            + cand["fused_step_bwd"]["launches"],
            "max_abs_err": max([fbwd_err, rc["bwd"]["max_abs_err"],
                                rc["bwd_billiards8"]["max_abs_err"], crates["bwd"]["max_abs_err"],
                                cand["fused_step_bwd"]["max_abs_err"]]
                               + [v["bwd"]["max_abs_err"] for v in large.values()]),
            "ms": fbwd_ms,
            "plain_ms": fbwd_plain_ms,
            "bound_ms": fb_bound,
            "bound_by": fb_by,
            "library_ms": None,
            "robocup": {"launches": rc_train["robocup fused"][1][3], **rc["bwd"]},
            "billiards8": {"launches": rc_train["billiards8 fused cue objective"][1][3], **rc["bwd_billiards8"]},
            "crates": {"launches": crate_grad["fused"][1][3], **crates["bwd"]},
            "billiards48": large["billiards48"]["bwd"],
            "billiards61": large["billiards61"]["bwd"],
            "override": large["override"]["bwd"],
            "fleet": {"launches": fleet["launches"][3]},
            "candidates": cand["fused_step_bwd"],
            **plans["fused_step_bwd"],
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
