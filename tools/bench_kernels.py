#!/usr/bin/env python3
"""Time the port's four kernels on the card, scene by scene, with their outputs' hashes.

    python3 tools/bench_kernels.py [--root DIR] [--batch 8192] [--plans 2,4,8]
    python3 tools/bench_kernels.py --compare PARENT_DIR [--batch 8192] [--out FILE]

Each scene is one of ``chip_smoke.py`` phase 3's, at the same inputs
(``tests/torch_scenarios.py``, numpy seeds): the lander's contact scenario,
the same on the lander's terrain-candidate world (28 lanes, 11 gathered
windows; phase 9), RoboCup's overlap state, billiards8's pairs state, the crate pile, the
mixed world (the solver only) and billiards48's pairs state (the solver
only, 52 bodies and 1,320 lanes).  For each it times the forward kernel
and the reverse pass of the solver (``contact_solver.solve_contacts``,
``solve_contacts_bwd``) or of the fused step
(``fused_step.physics_core_fused``, ``fused_step_bwd``) with CUDA events
(the mean of ``--reps`` calls after a warm-up, the best of two such
readings) and prints one JSON line per scene and kernel: the times by
worlds a block (``--plans``, through ``contact_solver.WORLDS_PER_BLOCK``;
a checkout without that setting only at its own plan), the kernel's bound on
these inputs (``chip_smoke.py``'s ``solver_bound_ms``, ``fused_bound_ms``,
``fused_bwd_bound_ms``), a SHA-256 of the bytes of its outputs at the
default plan, and the card's name and power limit.  ``--root`` imports
``parallax_tpu_torch`` from another checkout (the scenes still come from
this one's ``tests``), so that two versions of the kernels are timed
alike.  ``--compare`` runs the parent checkout, this one, this one and the
parent again, each in its own process, so the two are compared on one
card, and ends with one line per scene and kernel: the best time of each
at its default plan and whether every run's outputs hashed alike.  It
needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FWD = {"solve": "contact_solve_fwd", "fused": "fused_step_fwd"}
BWD = {"solve": "contact_solve_bwd", "fused": "fused_step_bwd"}


def scenes(B):
    """``(scene, kind, world, state, override, contacts, cotangents)``: kind
    "solve" takes the solver's planes (``contacts`` those of the state it
    is given), "fused" the fused step's."""
    import torch_scenarios as ts

    from parallax_tpu_torch.engine.batched import collide_batched, integrate_bm
    from parallax_tpu_torch.envs.billiards import Billiards, BilliardsConfig
    from parallax_tpu_torch.envs.lunar_lander import LanderConfig, LunarLander
    from parallax_tpu_torch.envs.robocup import RoboCup, RoboCupConfig

    def lanes(world, s, override=None, integrate=True):
        """The state the solve takes, no override, and its contact planes."""
        si = integrate_bm(world, s)[0] if integrate else s
        return si, None, collide_batched(world, si, override)

    out = []
    env = LunarLander(device="cuda")
    s, ov = ts.lander_contact_case(env, B, "cuda")
    cot = ts.cotangents(env.world.n_bodies, B, 5, "cuda")
    out.append(("lander", "solve", env.world, *lanes(env.world, s, ov, False), cot))
    env_f = LunarLander(LanderConfig(broadphase=False, use_cuda_fused=True), device="cuda")
    out.append(("lander", "fused", env_f.world, s, ov, None, cot))
    env_c = LunarLander(LanderConfig(terrain_candidates=True), device="cuda")
    s, ov = ts.candidate_contact_case(env_c, B, "cuda")
    wc = env_c._bm_world
    out.append(("lander_candidates", "solve", wc, *lanes(wc, s, ov, False), cot))
    env_cf = LunarLander(LanderConfig(terrain_candidates=True, broadphase=False,
                                      use_cuda_fused=True), device="cuda")
    out.append(("lander_candidates", "fused", env_cf._bm_world, s, ov, None, cot))
    rc = RoboCup(RoboCupConfig(use_cuda_fused=True), device="cuda")
    s = ts.robocup_overlap_state(rc, B, 0)
    cot = ts.cotangents(rc.world.n_bodies, B, 5, "cuda")
    out.append(("robocup", "fused", rc.world, s, None, None, cot))
    ws = RoboCup(device="cuda").world
    out.append(("robocup", "solve", ws, *lanes(ws, s), cot))
    bl = Billiards(BilliardsConfig(use_cuda_fused=True), device="cuda")
    s = ts.billiards_pairs_state(bl, B)
    cot = ts.cotangents(bl.world.n_bodies, B, 5, "cuda")
    out.append(("billiards8", "fused", bl.world, s, None, None, cot))
    ws = Billiards(device="cuda").world
    out.append(("billiards8", "solve", ws, *lanes(ws, s, None, False), cot))
    w, _ = ts.crate_world("cuda", fused=True)
    s = ts.crate_overlap_state(w, B)
    cot = ts.cotangents(w.n_bodies, B, 5, "cuda")
    out.append(("crates", "fused", w, s, None, None, cot))
    ws, _ = ts.crate_world("cuda")
    out.append(("crates", "solve", ws, *lanes(ws, s), cot))
    wm, st0 = ts.kinds_world("mixed", "cuda", use_cuda_solver=True)
    s = ts.kinds_state("mixed", wm, st0, B, pile=False)
    out.append(("mixed", "solve", wm, *lanes(wm, s),
                ts.cotangents(wm.n_bodies, B, 5, "cuda")))
    b48 = Billiards(BilliardsConfig(n_object=47), device="cuda")
    s = ts.billiards_pairs_state(b48, B)
    out.append(("billiards48", "solve", b48.world, *lanes(b48.world, s, None, False),
                ts.cotangents(b48.world.n_bodies, B, 5, "cuda")))
    return out


def cuda_ms(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def calls(kind, world, s, ov, con, cot):
    """The forward kernel's and the reverse pass's calls, each returning
    its output planes (the fused step's flags last of its forward's)."""
    from parallax_tpu_torch.ops import contact_solver, fused_step

    c = world.config
    args = (c.solver_iterations, c.position_iterations, c.dt, c.contact)
    if kind == "solve":
        def fwd():
            return tuple(contact_solver.solve_contacts(world, s, con, *args))

        def bwd():
            g = contact_solver.solve_contacts_bwd(world, s, con, cot, *args)
            return (*g[0], *g[1:])
    else:
        def fwd():
            out, con_ = fused_step.physics_core_fused(world, s, ov)
            return (*out, con_.active)

        def bwd():
            g = fused_step.fused_step_bwd(world, s, ov, cot)
            return (*g[0], *g[1:])
    return {FWD[kind]: fwd, BWD[kind]: bwd}


def bound(kernel, world, s, ov, con, B):
    """The least time of one call on these inputs, and what bounds it."""
    import torch
    from chip_smoke import fused_bound_ms, fused_bwd_bound_ms, solver_bound_ms, touched_pairs

    from parallax_tpu_torch.ops import fused_step

    c = world.config
    if kernel.startswith("contact"):
        return solver_bound_ms(int(con.active.sum()), B, world.table.n_contacts,
                               world.n_bodies, world.joints.n_joints, c.solver_iterations,
                               c.position_iterations, bwd=kernel.endswith("bwd"))
    with torch.no_grad():
        active = fused_step.fused_step_plain(world, s, ov)[1].active
    if kernel.endswith("fwd"):
        return fused_bound_ms(world, sorted(ov or {}), int(active.sum()), B)[:2]
    return fused_bwd_bound_ms(world, sorted(ov or {}), int(active.sum()),
                              touched_pairs(world, active), B)[:2]


def digest(planes):
    h = hashlib.sha256()
    for x in planes:
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def run(args):
    sys.path.insert(0, str(args.root))
    sys.path.insert(1, str(HERE / "tests"))
    sys.path.insert(2, str(HERE))
    import torch

    from parallax_tpu_torch.ops import contact_solver

    if not torch.cuda.is_available():
        sys.exit("bench_kernels: no CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    # a checkout without the setting is timed at its own launch plan only
    default = getattr(contact_solver, "WORLDS_PER_BLOCK", None)
    plans = [int(p) for p in args.plans.split(",")] if default else []
    for scene, kind, world, s, ov, con, cot in scenes(args.batch):
        for kernel, fn in calls(kind, world, s, ov, con, cot).items():
            times = {}
            for w in plans:
                contact_solver.WORLDS_PER_BLOCK = w
                cuda_ms(fn, 2)
                times[str(w)] = min(cuda_ms(fn, args.reps) for _ in range(2))
            if default:
                contact_solver.WORLDS_PER_BLOCK = default
            if str(default) not in times:
                cuda_ms(fn, 2)
                times["default"] = min(cuda_ms(fn, args.reps) for _ in range(2))
            sha = digest(fn())
            bound_ms, bound_by = bound(kernel, world, s, ov, con, args.batch)
            print(json.dumps({
                "root": str(args.root), "scene": scene, "kernel": kernel, "B": args.batch,
                "ms": times, "ms_default": times.get(str(default), times.get("default")),
                "bound_ms": bound_ms, "bound_by": bound_by, "sha256": sha, "gpu": gpu,
            }), flush=True)


def compare(args):
    """Parent, change, change, parent; then one summary line a scene and
    kernel."""
    lines = []
    for root in (args.compare, HERE, HERE, args.compare):
        cmd = [sys.executable, __file__, "--root", str(root), "--batch", str(args.batch),
               "--plans", args.plans, "--reps", str(args.reps)]
        out = subprocess.run(cmd, check=True, capture_output=True, text=True).stdout
        print(out, end="", flush=True)
        lines += [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    summary = []
    for key in dict.fromkeys((r["scene"], r["kernel"]) for r in lines):
        runs = [r for r in lines if (r["scene"], r["kernel"]) == key]
        parent = [r for r in runs if r["root"] == str(args.compare)]
        change = [r for r in runs if r["root"] == str(HERE)]
        summary.append({
            "scene": key[0], "kernel": key[1],
            "parent_ms": min(r["ms_default"] for r in parent),
            "change_ms": min(r["ms_default"] for r in change),
            "bits_equal": len({r["sha256"] for r in runs}) == 1,
            "change_plans_ms": change[0]["ms"], "bound_ms": change[0]["bound_ms"],
            "gpu": change[0]["gpu"],
        })
        print(json.dumps({"compare": summary[-1]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines + summary))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", type=Path, default=HERE, help="checkout whose kernels to time")
    p.add_argument("--compare", type=Path, default=None, help="parent checkout to time in turns")
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--plans", default="2,4,8")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default=None, help="with --compare: also write every line here")
    args = p.parse_args(argv)
    if args.compare is None:
        run(args)
    else:
        compare(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
