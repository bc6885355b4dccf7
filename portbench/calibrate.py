"""Readings that set a cell's limits: the program's compared numbers over
many seeds (sound runs), the control's (the reference in bfloat16 in the
program's place) and the faults' (the program broken underneath the timed
path), at the cell's own size, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 3] [--faults 3] [--units 2] [--out FILE]

Each reading is one JSON line (to ``--out`` and to standard output).  The
benchmark's own runs never run this; ``portbench/limits/<cell>.json`` keeps
the readings each limit was set from.
"""

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

# the faults each mix can have, planted by portbench/common.py:plant (and
# the train and shoot mixes' "optimizer": a step that leaves its state
# unchanged)
FAULTS = {"rollout": ("frozen", "half", "altered"),
          "train": ("optimizer", "half", "altered"),
          "shoot": ("optimizer", "half", "altered")}


def readings(workload, seed, units, device, kinds, overrides=None, fault=None):
    """One session at the cell's size: ``units`` units of the timed path,
    then the compared numbers of each of ``kinds`` (``sound`` or
    ``control``)."""
    from portbench import harness

    spec = harness.load_spec(ROOT)
    ctx = harness.make_context(spec, workload, seed, device, overrides, fault)
    t0 = time.perf_counter()
    session = harness.mix_module(ctx.cell["traffic"]).Session(ctx)
    for _ in range(units):
        session.unit()
    session.release()
    out = []
    for kind in kinds:
        numbers = session.check() if kind == "sound" else session.control()
        out.append({"workload": workload, "seed": seed, "kind": kind if fault is None
                    else f"fault:{fault}", "numbers": numbers,
                    "seconds": time.perf_counter() - t0})
    del session
    gc.collect()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    ap.add_argument("--faults", type=int, default=3, help="seeds that also read each fault")
    ap.add_argument("--units", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from portbench import harness

    mix = harness.cell_of(harness.load_spec(ROOT), args.workload)["traffic"]
    seeds = [int(s) for s in args.seeds.split(",")]
    sink = open(args.out, "a") if args.out else None
    try:
        for i, seed in enumerate(seeds):
            kinds = ["sound"] + (["control"] if i < args.control else [])
            lines = readings(args.workload, seed, args.units, args.device, kinds)
            if i < args.faults:
                for fault in FAULTS[mix]:
                    lines += readings(args.workload, seed, args.units, args.device,
                                      ["sound"], fault=fault)
            for line in lines:
                text = json.dumps(line)
                print(text, flush=True)
                if sink:
                    sink.write(text + "\n")
                    sink.flush()
            if args.device == "cuda":
                torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()


if __name__ == "__main__":
    main()
