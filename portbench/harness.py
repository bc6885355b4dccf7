"""The benchmark's harness: finds a cell's configuration, traffic mix,
per-layer readers and limits by the names in ``BENCHMARK.json``, runs the
set-up, the measured window, the traced stretch and the correctness check,
and assembles the result line.

Everything that belongs to one configuration, mix or metric lives in files
of its own, found by name:

* ``portbench/configs/<config>.json``: the env, its config flags, source;
* ``portbench/traffic/<mix>.json`` and its module ``traffic/<mix>.py``;
* ``portbench/layers/<metric>.py``: one reader per per-layer metric;
* ``portbench/limits/<cell>.json``: the limits of the cell's compared
  numbers, with the readings they were set from.

The program under test is ``parallax_tpu_torch``; the plain reference is
``portbench/reference``.  Neither JAX nor the JAX package is imported.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace

import torch

from portbench import roofline

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "parallax_tpu")


# ---------------------------------------------------------------------------
# finding things by name
# ---------------------------------------------------------------------------


def load_spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no BENCHMARK.json beside the benchmark")
    return json.loads(path.read_text())


def cell_of(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    names = ", ".join(w["name"] for w in spec["workloads"])
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json (cells: {names})")


def config_of(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path}: missing")
    mod_name = "portbench._found." + name.replace(".", "_").replace("-", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def mix_params(mix: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{mix}.json").read_text())


def mix_module(mix: str) -> ModuleType:
    return _module(BENCH / "traffic" / f"{mix}.py", f"traffic.{mix}")


def reader(metric: str) -> ModuleType:
    return _module(BENCH / "layers" / f"{metric}.py", f"layers.{metric}")


def limits_of(workload: str) -> dict:
    path = BENCH / "limits" / f"{workload}.json"
    return json.loads(path.read_text()) if path.is_file() else {}


def per_world_parts(world, config: dict) -> list:
    """The parts whose vertices each world holds itself (``"static"``: the
    static bodies' parts, the lander's terrain), read by the roofline
    counts; ``"none"`` where the world has none."""
    rule = config.get("per_world_parts", "none")
    if rule == "none":
        return []
    if rule != "static":
        raise ValueError(f"per_world_parts: {rule!r} is neither 'static' nor 'none'")
    return [p for p, b in enumerate(world.parts.body) if world.static_bodies[b]]


def metrics_of(spec: dict, workload: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports: those
    whose ``workloads`` list names it, or that have no such list."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def card_line() -> str:
    """The card's name and power limit, from ``nvidia-smi`` where it runs."""
    import subprocess

    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
        return out[0] if out else name
    except (OSError, subprocess.SubprocessError):
        return f"{name}, power limit not read"


def make_context(spec, workload, seed, device, overrides=None, fault=None):
    """What a mix's session is built from: the cell, its configuration's file,
    its mix's parameters (``overrides`` replace some, for tests at small
    sizes), the seed, the device and a planted fault (tests only)."""
    cell = cell_of(spec, workload)
    params = mix_params(cell["traffic"])
    params.update(overrides or {})
    return SimpleNamespace(
        workload=workload, cell=cell, config=config_of(spec, cell["config"]),
        params=params, seed=int(seed), device=torch.device(device), fault=fault,
        limits=limits_of(workload),
    )


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(session, seconds: float, device) -> dict:
    """Run units back to back for ``seconds``: every unit ends in one host
    read of its witness, so the last completed unit closes the window; the
    rate is all the work of the completed units over the time from the
    window's start to the last one's read."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    attempted = failed = 0
    t0 = time.perf_counter()
    t_last = t0
    durations = []
    while True:
        attempted += 1
        try:
            w = session.unit()
            if not math.isfinite(w):
                failed += 1
        except Exception as exc:  # a unit that raises counts as failed; the run goes on
            failed += 1
            print(f"unit {attempted} failed: {exc!r}", file=sys.stderr)
            if failed >= 3:
                break
        durations.append(time.perf_counter() - t_last)
        t_last += durations[-1]
        if t_last - t0 >= seconds:
            break
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return {"attempted": attempted, "failed": failed, "seconds": t_last - t0,
            "work": (attempted - failed) * session.work, "peak_bytes": peak,
            "durations": durations}


def rate(work: float, seconds: float) -> float:
    """All the work of the window over all its time."""
    if seconds <= 0:
        raise ValueError("an empty window has no rate")
    return work / seconds


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``parallax_tpu_torch`` is the program, not the JAX
    package)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def judge(numbers: dict, limits: dict) -> tuple:
    """Each compared number beside its limit: within it when it is a finite
    number no larger than the limit.  A number without a limit fails."""
    compared = {k: {"value": v, "limit": limits.get(k, {}).get("limit")}
                for k, v in numbers.items()}
    ok = bool(compared) and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())
    return ok, compared


def run_cell(workload, seed, seconds, trace, device="cuda", t_start=None,
             overrides=None, fault=None, spec=None, log=None):
    """One run of one cell: set-up, window, optionally the traced stretch,
    then the check.  Returns the result dict (without the import check,
    which the caller makes once the window has closed)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = spec or load_spec()
    ctx = make_context(spec, workload, seed, device, overrides, fault)
    dev = ctx.device
    session = mix_module(ctx.cell["traffic"]).Session(ctx)
    sync(dev)
    setup_s = time.perf_counter() - t_start
    shapes = roofline.world_shapes(session.env.world,
                                   per_world_parts(session.env.world, ctx.config))
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"[setup] {workload} seed {seed}: {setup_s:.3f} s")

    win = window(session, seconds, dev)
    d = sorted(win["durations"])
    log(f"[window] {win['attempted']} units ({win['failed']} failed) in {win['seconds']:.3f} s; "
        f"a unit {d[0]:.4f} / {d[len(d) // 2]:.4f} / {d[-1]:.4f} s (least / median / most)")
    result = {"attempted": win["attempted"], "failed": win["failed"]}
    peak_bytes = max(setup_peak, win["peak_bytes"])

    metrics = {}
    breakdown = None
    device_info = {}
    if trace:
        from portbench import tracing

        traced = tracing.trace_units(session, dev)
        traced.shapes, traced.batch = shapes, ctx.params["batch"]
        # the untraced window's time a unit: the profiler slows the host, so
        # the traced stretch's own length would mostly measure the profiler
        traced.unit_s = win["seconds"] / max(win["attempted"], 1)
        device_info = {"busy_s": traced.busy_s, "window_s": traced.window_s}
        breakdown = traced.breakdown
        for m in metrics_of(spec, workload, "per_layer"):
            value = reader(m["name"]).read(traced)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        peak_bytes = max(peak_bytes, traced.peak_bytes)
    else:
        for m in metrics_of(spec, workload, "end_to_end"):
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == "peak_mem_gib":
                value = win["peak_bytes"] / 2**30
            elif m["name"] == session.rate_metric:
                value = rate(win["work"], win["seconds"])
            else:
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    session.release()
    t_check = time.perf_counter()
    ok, compared = judge(session.check(), ctx.limits)
    log(f"[check] {time.perf_counter() - t_check:.3f} s")
    result.update(
        correct=bool(ok and win["failed"] == 0),
        metrics=metrics,
        device={
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak_bytes),
            **device_info,
        },
    )
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["shapes"] = shapes
    result["compared"] = compared
    return result

