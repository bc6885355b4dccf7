"""Profiling helpers.

The port of ``utils/profiling.py``:

* ``named``: the program's span, a context manager that labels a region in
  profiler traces (``torch.profiler.record_function``, the twin of
  ``jax.named_scope``) while spans are on, and a shared no-op otherwise;
* ``spans``: turn the spans on for a block;
* ``trace``: capture a ``torch.profiler`` trace of a block, spans on, and
  write it as a Chrome trace (``chrome://tracing``, Perfetto) under
  ``log_dir``.

The spans are off unless something turns them on: ``record_function``
costs some microseconds a span even with no profiler running, and under a
CUDA profile each span also puts a ``gpu_user_annotation`` range on the
device's row (from the first kernel launched inside it to the last), which
is not a kernel.  The flag is a module global, not thread-local, so spans
entered on autograd's engine thread (a checkpoint's recompute) show too.
"""

from __future__ import annotations

import contextlib
import os

import torch

_ON = False
_OFF = contextlib.nullcontext()


def named(name: str):
    """A span named ``name``: ``record_function(name)`` while spans are on
    (:func:`spans`), a shared ``nullcontext`` otherwise."""
    if _ON:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def spans():
    """Turn the program's spans on for the block; the previous state comes
    back on exit, exceptions included."""
    global _ON
    before, _ON = _ON, True
    try:
        yield
    finally:
        _ON = before


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU ops, and CUDA kernels where the machine has a
    card) with the spans on and write ``log_dir/trace.json``; yields the
    profiler, whose ``key_averages()`` sums the events by name."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with spans(), torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
