#!/usr/bin/env python3
"""Time the port's two reverse-pass kernels on the card, scene by scene.

    python3 tools/bench_reverse.py [--root DIR] [--batch 8192] [--plans 2,4,8]
    python3 tools/bench_reverse.py --compare PARENT_DIR [--batch 8192]

Each scene is one of ``chip_smoke.py`` phase 3's, at the same inputs
(``tests/torch_scenarios.py``, numpy seeds): the lander's contact scenario,
RoboCup's overlap state, billiards8's pairs state, the crate pile, the
mixed world (the solver reverse pass only) and billiards48's pairs state
(the solver reverse pass only, 52 bodies and 1,320 lanes).  For each it
times ``contact_solver.solve_contacts_bwd`` and ``fused_step.fused_step_bwd``
with CUDA events (the mean of ``--reps`` calls after a warm-up, the best of
two such readings) and prints one JSON line per scene and kernel, with the
card's name and power limit and the kernel's bound on these inputs
(``chip_smoke.py``'s ``solver_bound_ms`` and ``fused_bwd_bound_ms``).  ``--plans`` times each number of worlds a
block (``contact_solver.BWD_WORLDS_PER_BLOCK``) where the checkout has the
setting.  ``--root`` imports ``parallax_tpu_torch`` from another checkout
(the scenes still come from this one's ``tests``), so that two versions of
the kernels are timed alike; ``--compare`` runs the parent checkout, this
one, this one and the parent again, each in its own process, so the two
are compared on one card.  It needs an NVIDIA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def scenes(B):
    """``(scene, kernel, world, state, override, contacts, cotangents)``."""
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
    rc = RoboCup(RoboCupConfig(use_cuda_fused=True), device="cuda")
    s = ts.robocup_overlap_state(rc, B, 0)
    cot = ts.cotangents(rc.world.n_bodies, B, 5, "cuda")
    out.append(("robocup", "fused", rc.world, s, None, None, cot))
    ws = RoboCup(device="cuda").world
    out.append(("robocup", "solve", ws, *lanes(ws, s), cot))
    bl = Billiards(BilliardsConfig(use_cuda_fused=True), device="cuda")
    s = ts.billiards_pairs_state(bl, B)
    out.append(("billiards8", "fused", bl.world, s, None, None,
                ts.cotangents(bl.world.n_bodies, B, 5, "cuda")))
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


def bound(kernel, world, s, ov, con, B):
    """The least time of one call on these inputs, and what bounds it."""
    import torch
    from chip_smoke import fused_bwd_bound_ms, solver_bound_ms, touched_pairs

    from parallax_tpu_torch.ops import fused_step

    c = world.config
    if kernel == "solve":
        return solver_bound_ms(int(con.active.sum()), B, world.table.n_contacts,
                               world.n_bodies, world.joints.n_joints, c.solver_iterations,
                               c.position_iterations, bwd=True)
    with torch.no_grad():
        active = fused_step.fused_step_plain(world, s, ov)[1].active
    return fused_bwd_bound_ms(world, sorted(ov or {}), int(active.sum()),
                              touched_pairs(world, active), B)[:2]


def run(args):
    sys.path.insert(0, str(args.root))
    sys.path.insert(1, str(HERE / "tests"))
    sys.path.insert(2, str(HERE))
    import torch

    from parallax_tpu_torch.ops import contact_solver, fused_step

    if not torch.cuda.is_available():
        sys.exit("bench_reverse: no CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    has_plan = hasattr(contact_solver, "BWD_WORLDS_PER_BLOCK")
    plans = [int(p) for p in args.plans.split(",")] if has_plan else [None]
    for scene, kernel, world, s, ov, con, cot in scenes(args.batch):
        c = world.config
        solve_args = (c.solver_iterations, c.position_iterations, c.dt, c.contact)
        if kernel == "solve":
            def fn():
                contact_solver.solve_contacts_bwd(world, s, con, cot, *solve_args)
        else:
            def fn():
                fused_step.fused_step_bwd(world, s, ov, cot)
        times = {}
        for w in plans:
            if w is not None:
                contact_solver.BWD_WORLDS_PER_BLOCK = w
            cuda_ms(fn, 2)
            times[str(w)] = min(cuda_ms(fn, args.reps) for _ in range(2))
        bound_ms, bound_by = bound(kernel, world, s, ov, con, args.batch)
        print(json.dumps({"root": str(args.root), "scene": scene, "kernel": kernel,
                          "B": args.batch, "ms": times, "bound_ms": bound_ms,
                          "bound_by": bound_by, "gpu": gpu}), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", type=Path, default=HERE, help="checkout whose kernels to time")
    p.add_argument("--compare", type=Path, default=None, help="parent checkout to time in turns")
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--plans", default="2,4,8")
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if args.compare is None:
        run(args)
        return 0
    for root in (args.compare, HERE, HERE, args.compare):
        cmd = [sys.executable, __file__, "--root", str(root), "--batch", str(args.batch),
               "--plans", args.plans, "--reps", str(args.reps)]
        subprocess.run(cmd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
