"""The program's own spans (``px.*``, ``parallax_tpu_torch/utils/profiling.py``)
over a stretch of the timed path, read into device kernels, device time,
host time and device idle time by span.

The first reader that asks for them profiles ``session.trace_units`` more
units of the cell's timed path with the spans on, after the traced stretch
of :func:`portbench.tracing.trace_units` (which keeps them off, so its
counts hold no annotation range), and stores the record on the harness's
``traced`` record for the other readers.  Every time is the profiler's
own: the spans are the host's ``user_annotation`` events, the kernels the
device's, on one clock.

* A device kernel is matched through its correlation id to the runtime
  call that launched it, and belongs to the innermost span open on that
  call's thread when it was made (autograd's engine thread is a thread of
  its own); a kernel outside every span is ``(unspanned)``.  The device's
  ``gpu_user_annotation`` ranges, copies and fills are not kernels.
* The device's busy time is the union of its kernels, copies and fills;
  an idle gap belongs to the narrowest span open at its midpoint on any
  host thread.
* A span's host time is the sum of its durations.

A program without spans (no ``profiling.spans``), or a stretch in which
none ran, gives no record, and the readers read nothing.
"""

from __future__ import annotations

import bisect
import re
import sys
from collections import defaultdict
from types import SimpleNamespace

import torch
from torch.profiler import ProfilerActivity, profile

from portbench.tracing import _union

PREFIX = "px."
UNSPANNED = "(unspanned)"
TOP = 10
# the CUDA API's calls on the host: cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...
_RUNTIME = re.compile(r"cu(da)?[A-Z]")


def _events(prof):
    """The profiler's raw kineto events as tuples
    ``(device, name, start_ns, end_ns, correlation, thread, annotation)``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "cuda" if e.device_type() == torch.autograd.DeviceType.CUDA else "cpu"
        start = e.start_ns()
        out.append((dev, e.name(), start, start + e.duration_ns(), e.correlation_id(),
                    e.start_thread_id(), e.is_user_annotation()))
    return out


class _Innermost:
    """The innermost open span at any time on one thread: the spans' edges
    swept into segments, each labelled with the span that opened last and
    is still open (the narrowest, since spans on a thread nest)."""

    def __init__(self, spans):
        spans = [sp for sp in spans if sp[1] > sp[0]]
        edges = sorted({t for s, e, _ in spans for t in (s, e)})
        opens, closes = defaultdict(list), defaultdict(list)
        for i, (s, e, _) in enumerate(spans):
            opens[s].append(i)
            closes[e].append(i)
        self.starts, self.labels = [], []
        stack = []
        for t in edges:
            for i in closes[t]:
                stack.remove(i)
            # the widest first, so the narrowest of those opening together is on top
            stack.extend(sorted(opens[t], key=lambda i: spans[i][0] - spans[i][1]))
            top = spans[stack[-1]] if stack else None
            self.starts.append(t)
            self.labels.append((top[2], top[1] - top[0]) if top else None)

    def at(self, t):
        """``(name, width)`` of the innermost span open at ``t``, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        return self.labels[i] if i >= 0 else None


def attribute(events):
    """Kernels, device seconds, host seconds and idle seconds by span, from
    ``events`` as :func:`_events` gives them.  Returns a record with
    ``kernels`` and ``kernel_s`` (by span, ``(unspanned)`` included; the
    counts sum to ``n_kernels``), ``host_s`` (by span that ran), ``idle_s``
    (by span, ``(unspanned)`` included) and ``idle_total_s``."""
    spans_by_thread = defaultdict(list)
    host_s = defaultdict(float)
    launches = {}  # CUPTI's correlation id -> (time, thread) of the CUDA API call
    for d, n, s, e, corr, tid, ann in events:
        if d != "cpu":
            continue
        if ann and n.startswith(PREFIX):
            spans_by_thread[tid].append((s, e, n))
            host_s[n] += (e - s) * 1e-9
        elif _RUNTIME.match(n):
            launches[corr] = (s, tid)
    inner = {tid: _Innermost(sp) for tid, sp in spans_by_thread.items()}

    def span_at(tid, t):
        found = inner[tid].at(t) if tid in inner else None
        return found[0] if found else UNSPANNED

    kernels, kernel_s, device = defaultdict(int), defaultdict(float), []
    for d, n, s, e, corr, _, ann in events:
        if d != "cuda" or ann:  # an annotation's range, not device work
            continue
        device.append((s, e))
        if n.startswith(("Memcpy", "Memset")):
            continue
        call = launches.get(corr)
        name = span_at(call[1], call[0]) if call else UNSPANNED
        kernels[name] += 1
        kernel_s[name] += (e - s) * 1e-9

    lo = min((ev[2] for ev in events), default=0)
    hi = max((ev[3] for ev in events), default=lo)
    busy = _union([(max(s, lo), min(e, hi)) for s, e in device if e > s])
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle_s = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        found = [f for f in (m.at(mid) for m in inner.values()) if f]
        name = min(found, key=lambda f: f[1])[0] if found else UNSPANNED
        idle_s[name] += (b - a) * 1e-9
    return SimpleNamespace(
        kernels=dict(kernels), kernel_s=dict(kernel_s), n_kernels=sum(kernels.values()),
        host_s=dict(host_s), idle_s=dict(idle_s),
        idle_total_s=sum(idle_s.values()),
    )


def _log(rec, workload):
    """Three lines on standard error: the idle seconds of the ten spans
    with the most, and every span's kernels and host ms a step."""
    def line(what, values, fmt, top=None):
        ranked = sorted(values.items(), key=lambda x: -x[1])[:top]
        print(f"[spans] {workload} {what}: " + ", ".join(f"{n} {fmt(v)}" for n, v in ranked),
              file=sys.stderr, flush=True)

    line(f"idle by span (s, of {rec.idle_total_s:.4f})", rec.idle_s, "{:.4f}".format, TOP)
    line(f"kernels by span (of {rec.n_kernels} in {rec.steps} steps)", rec.kernels, str)
    line("host ms a step by span", rec.host_s, lambda v: f"{1e3 * v / rec.steps:.4f}")


def of(traced):
    """The span record of this run, profiled on the first call and kept on
    ``traced``; None where the device is not CUDA or the program has no
    spans."""
    if hasattr(traced, "spans"):
        return traced.spans
    traced.spans = None
    session = traced.session
    if session.device.type != "cuda":
        return None
    from parallax_tpu_torch.utils import profiling

    spans_on = getattr(profiling, "spans", None)
    if spans_on is None:
        return None
    n = session.trace_units
    torch.cuda.synchronize(session.device)
    with spans_on(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            session.unit()
        torch.cuda.synchronize(session.device)
    rec = attribute(_events(prof))
    del prof
    if not rec.host_s:
        return None
    rec.units, rec.steps = n, n * session.steps_per_unit
    _log(rec, session.ctx.workload)
    traced.spans = rec
    return rec
