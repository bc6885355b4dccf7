"""The split step's collide, ``engine/batched.py:collide_batched``, ms a
call on the states the window reached: CUDA events around calls after the
window.  Nothing to read on the fused step, or on a world whose parts each
world holds itself."""

import torch

CALLS = 5


def read(traced):
    s = traced.session
    world = s.env.world
    state = getattr(s, "state", None)
    if (state is None or s.device.type != "cuda" or world.config.use_cuda_fused
            or traced.shapes["per_world_parts"]):
        return None
    from parallax_tpu_torch.engine.batched import collide_batched

    planes = s.env._to_planes(state).s
    collide_batched(world, planes)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        collide_batched(world, planes)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS
