"""Profiling helpers.

The port of ``utils/profiling.py``:

* ``named``: a context manager that labels a region in profiler traces
  (``torch.profiler.record_function``, the twin of ``jax.named_scope``);
* ``trace``: capture a ``torch.profiler`` trace of a block and write it as
  a Chrome trace (``chrome://tracing``, Perfetto) under ``log_dir``;
* ``steps_per_second``: best-of-N blocked timing.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch

from parallax_tpu_torch.utils.pytree import tree_leaves

named = torch.profiler.record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU ops, and CUDA kernels where the machine has a
    card) and write ``log_dir/trace.json``; yields the profiler, whose
    ``key_averages()`` sums the events by name."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _block(out) -> None:
    """Wait for ``out``: one ``torch.cuda.synchronize()`` where it holds a
    CUDA tensor (PyTorch returns before the card finishes)."""
    if any(torch.is_tensor(x) and x.is_cuda for x in tree_leaves(out)):
        torch.cuda.synchronize()


def steps_per_second(fn: Callable, *args, steps_per_call: int = 1, repeats: int = 3):
    """Best-of-N blocked timing (one warm-up call first); returns steps/s."""
    _block(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _block(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return steps_per_call / best
