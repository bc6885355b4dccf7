"""Run one cell of the port's benchmark once, on the card this machine has.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell, its configuration, traffic mix,
metrics and limits come from ``BENCHMARK.json`` and the files under
``portbench/`` it names.  Standard error carries the card's name and power
limit first, and the compared numbers beside their limits last; the last
line of standard output is the result as one JSON object.  Without a card
(or with fewer than the cell asks for) it exits 2 and prints no result; if
JAX or the JAX package is loaded once the window has closed, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths (the
# program's own kernels build into build/kernels); nothing loads flax
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import harness

    spec = harness.load_spec(ROOT)
    chips = harness.cell_of(spec, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), this machine has {found}; "
              "no result", file=sys.stderr)
        return 2
    print(f"[card] {harness.card_line()}", file=sys.stderr, flush=True)

    result = harness.run_cell(args.workload, args.seed, args.seconds, args.trace,
                              device="cuda", t_start=T_START, spec=spec)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    shapes = result.pop("shapes")
    compared = result.pop("compared")
    result["compared"] = compared  # the key of its own that comes last
    out = ROOT / "build" / "portbench"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{args.workload}.trace{args.trace}.json").write_text(
        json.dumps({**result, "shapes": shapes}, indent=1))
    for name, c in compared.items():
        print(f"[compared] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
