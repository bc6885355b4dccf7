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
  and circle-box lanes, and no solver launch).

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


def mlp_params(device):
    """The train policy's weights: obs 9 -> 32 tanh -> 2 tanh (numpy, seeded)."""
    rng = np.random.default_rng(0)
    arrays = {
        "w1": rng.standard_normal((9, 32)) * 0.3,
        "b1": np.zeros(32),
        "w2": rng.standard_normal((32, 2)) * 0.1,
        "b2": np.zeros(2),
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
    every circle pair its lane (``CC_OPS``, ``CB_OPS``), every rotated
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
    are skipped) runs its SAT again and its adjoint: about 17 a vertex of
    both polygons (the projection chains replayed and walked back) and 160
    for the clips, the tangent and the edge normal."""
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
        t * (pair_ops(va, vb) + 17 * (va + vb) + 160)
        for t, (_, _, va, vb, *_) in zip(touched, ops_.pair_i.tolist())
    )
    ops = f_ops + 2 * solve_ops + adjoint
    terrain_rows = sum(parts[p][2] for p in override_parts)
    nbytes = (18 * n + 2 * terrain_rows + 2 * MAX_VERTS * len(override_parts)) * B * 4
    t_bytes, t_ops = nbytes / HBM_BPS, ops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


# float32 operations of one circle-circle and one circle-box lane, counted
# from fused_step.cuh's cc_lane and cb_lane
CC_OPS, CB_OPS = 45, 60


def pair_ops(va, vb, kind=0):
    """float32 operations of one pair's lanes (see fused_bound_ms): a
    polygon pair's SAT and clip (kind 0), or a circle pair's analytic lane
    (kind 1: cc, 2: cb)."""
    if kind:
        return CC_OPS if kind == 1 else CB_OPS
    A = va + vb
    return 9 * A + A * (3 * A + 2 * (A - 2) + 4) + 4 * A + 85


def circle_params(width, device):
    """A tanh-linear policy's weights for an env of ``width`` observations
    (numpy, seeded)."""
    rng = np.random.default_rng(12)
    W = (rng.standard_normal((width, 2)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(2) * 0.3).astype(np.float32)
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
    bwd_err = 0.0
    names = list(s._fields) + ["pen_x", "pen_y", "pt_x", "pt_y"]
    for f, a, b in zip(names, (*got[0], *got[1:]), (*want[0], *want[1:])):
        err = (a - b).abs()
        check(torch.isfinite(a).all().item(), f"reverse pass: non-finite {f}")
        check((err <= ATOL + RTOL * b.abs()).all().item(),
              f"reverse pass vs plain VJP: {f} differs by {err.max().item()}")
        bwd_err = max(bwd_err, err.max().item())
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
    fbwd_err = 0.0
    for f, a, b in zip([*s._fields, "terrain x", "terrain y"], (*got[0], *got[1:]),
                       (*want[0], *want[1:])):
        err = (a - b).abs()
        check(torch.isfinite(a).all().item(), f"fused reverse pass: non-finite {f}")
        check((err <= ATOL + RTOL * b.abs()).all().item(),
              f"fused reverse pass vs plain VJP: {f} differs by {err.max().item()}")
        fbwd_err = max(fbwd_err, err.max().item())
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
    touched = want_c.active.view(-1, 2, B).any(1).sum(1).tolist()
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
        err_max = 0.0
        for a, b in zip((*g_[0], *g_[1:]), (*w_[0], *w_[1:])):
            err = (a - b).abs()
            check(torch.isfinite(a).all().item(), f"{label} at a clamp tie: non-finite")
            check((err <= ATOL + RTOL * b.abs()).all().item(),
                  f"{label} at a clamp tie vs plain VJP: differs by {err.max().item()}")
            err_max = max(err_max, err.max().item())
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
    lap("done")
    print(json.dumps({"kernels": [
        {
            "name": "contact_solve_fwd",
            "route": "cuda",
            "source": "parallax_tpu_torch/csrc/contact_solver.cu",
            "replaces": "parallax_tpu/ops/pallas_solver.py:581",
            # the lander's rollout and the circle worlds' split rollouts
            "launches": launches + sum(circle[f"{k} split"][1][0] for k in solves),
            "max_abs_err": max_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": fwd_bound,
            "bound_by": fwd_by,
            "library_ms": None,
            **{k: {"launches": circle[f"{k} split"][1][0], **v} for k, v in solves.items()},
        },
        {
            "name": "contact_solve_bwd",
            "route": "cuda",
            "source": "parallax_tpu_torch/csrc/contact_solver_bwd.cu",
            "replaces": "parallax_tpu/ops/pallas_solver.py:534",
            "launches": train["split"][1][1],
            "max_abs_err": bwd_err,
            "ms": bwd_ms,
            "plain_ms": bwd_plain_ms,
            "bound_ms": bwd_bound,
            "bound_by": bwd_by,
            "library_ms": None,
        },
        {
            "name": "fused_step_fwd",
            "route": "cuda",
            "source": "parallax_tpu_torch/csrc/fused_step.cu",
            "replaces": "parallax_tpu/ops/pallas_step.py:473",
            "lanes": ["pp", "cc", "cb"],
            # the lander's fused rollout (pp) and billiards8's (cc, cb)
            "launches": fused_launches + circle["billiards8 fused"][1][1],
            "max_abs_err": fused_err,
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
        },
        {
            "name": "fused_step_bwd",
            "route": "cuda",
            "source": "parallax_tpu_torch/csrc/fused_step_bwd.cu",
            "replaces": "parallax_tpu/ops/pallas_step.py:495",
            "launches": train["fused"][1][3],
            "max_abs_err": fbwd_err,
            "ms": fbwd_ms,
            "plain_ms": fbwd_plain_ms,
            "bound_ms": fb_bound,
            "bound_by": fb_by,
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
