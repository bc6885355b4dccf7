"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a few
of the cell's units after the window, read into device-kernel counts and
times by name, the device's busy time, the idle gaps named by the host
operation the profiler shows running in each, and the run's active lanes
from a second, untraced stretch.

The per-layer readers (``portbench/layers``) read the record
:func:`trace_units` returns.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from types import SimpleNamespace

import torch
from torch.profiler import ProfilerActivity, profile

# at most this many entries in each list of the breakdown
TOP = 10


def _raw_events(prof):
    """The profiler's events as ``(device, name, start_ns, end_ns)``, from
    its raw kineto results (no per-event Python objects, no trace file)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "cuda" if e.device_type() == torch.autograd.DeviceType.CUDA else "cpu"
        start = e.start_ns()
        out.append((dev, e.name(), start, start + e.duration_ns()))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _is_kernel(name):
    """A device event that is a kernel, not a copy or a fill."""
    return not name.startswith(("Memcpy", "Memset"))


def summarize(events, t0_ns, t1_ns):
    """Kernel counts and seconds by name, busy seconds (the union of the
    device's events), and the idle gaps between them summed by the host
    operation covering each gap's middle (the innermost of the 64 that
    started last; "host: between operations" where none covers it, which
    is Python running between two operations)."""
    dev = [(n, s, e) for d, n, s, e in events if d == "cuda" and e > s]
    kernels = defaultdict(lambda: [0, 0.0])
    for n, s, e in dev:
        if _is_kernel(n):
            kernels[n][0] += 1
            kernels[n][1] += (e - s) * 1e-9
    busy = _union([(max(s, t0_ns), min(e, t1_ns)) for _, s, e in dev if e > t0_ns and s < t1_ns])
    busy_s = sum(e - s for s, e in busy) * 1e-9

    host = sorted((s, e, n) for d, n, s, e in events
                  if d == "cpu" and not n.startswith("cuda") and e > s)
    starts = [h[0] for h in host]
    gaps = []
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    by_host = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        name, width = "host: between operations", None
        i = bisect.bisect_right(starts, mid)
        for s, e, n in reversed(host[max(0, i - 64):i]):
            if e >= mid and (width is None or e - s < width):
                name, width = n, e - s
        by_host[name] += (b - a) * 1e-9
    return kernels, busy_s, by_host


def _active_counter(env):
    """Wrap the env's post hook (on the instance) to sum, per step, the
    active lanes and, per pair of the table, the worlds where one of its
    lanes is active.  Returns ``(undo, record)``."""
    record = SimpleNamespace(steps=0, active=None, touched=None)
    post = env.plane_post
    widths = [2 if g.kernel == "pp" else 1 for g in env.world.table.groups for _ in g.part_a]
    pair_of_lane = torch.repeat_interleave(
        torch.arange(len(widths)), torch.tensor(widths, dtype=torch.long)
    )

    def counted(s, aux, con, actions, t_new):
        act = con.active
        n = act.sum()
        per_pair = torch.zeros((len(widths), act.shape[-1]), device=act.device)
        per_pair.index_add_(0, pair_of_lane.to(act.device), act.to(per_pair.dtype))
        touched = (per_pair > 0).sum(1)
        record.steps += 1
        record.active = n if record.active is None else record.active + n
        record.touched = touched if record.touched is None else record.touched + touched
        return post(s, aux, con, actions, t_new)

    env.plane_post = counted

    def undo():
        del env.plane_post

    return undo, record


def trace_units(session, device):
    """Profile ``session.trace_units`` units of the timed path, then count
    the active lanes over as many more, untraced (the counting adds
    operations of its own); returns the record the per-layer readers
    read."""
    n = session.trace_units
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            session.unit()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        host_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    events = _raw_events(prof)
    # the traced window, on the profiler's clock: its first to its last event
    lo = min((s for _, _, s, _ in events), default=0)
    hi = max((e for _, _, _, e in events), default=lo)
    window_s = (hi - lo) * 1e-9 or host_s
    kernels, busy_s, idle = summarize(events, lo, hi)
    del prof, events

    undo, record = _active_counter(session.env)
    try:
        for _ in range(n):
            session.unit()
    finally:
        undo()
    steps = max(record.steps, 1)
    active = float(record.active) / steps if record.active is not None else 0.0
    touched = ([float(x) / steps for x in record.touched.tolist()]
               if record.touched is not None else [])

    top_ops = sorted(((k, v[1]) for k, v in kernels.items()), key=lambda x: -x[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda x: -x[1])[:TOP]
    return SimpleNamespace(
        session=session,
        units=n,
        steps=n * session.steps_per_unit,
        kernels={k: {"count": v[0], "seconds": v[1]} for k, v in kernels.items()},
        n_kernels=sum(v[0] for v in kernels.values()),
        busy_s=busy_s,
        window_s=window_s,
        active_per_step=active,
        touched_per_step=touched,
        peak_bytes=peak,
        breakdown={"device_ops": [[k, v] for k, v in top_ops],
                   "idle_gaps": [[k, v] for k, v in top_idle]},
    )


def kernel_ms(traced, fragment):
    """Mean milliseconds a call of the kernels whose name holds
    ``fragment``, or None where none ran."""
    hits = [v for k, v in traced.kernels.items() if fragment in k]
    count = sum(v["count"] for v in hits)
    return 1e3 * sum(v["seconds"] for v in hits) / count if count else None
