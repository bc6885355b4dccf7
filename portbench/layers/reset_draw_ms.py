"""The auto-reset draw, ``plane_fresh`` (the lander's threefry terrain,
billiards' rack jitter), ms a call at the cell's batch: CUDA events around
calls after the window, timed from outside the program."""

import torch

CALLS = 10


def read(traced):
    s = traced.session
    fresh = getattr(s.env, "plane_fresh", None)
    if fresh is None or s.device.type != "cuda":
        return None
    keys = s.keys
    fresh(keys)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fresh(keys)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS
