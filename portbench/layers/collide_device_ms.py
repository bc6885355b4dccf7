"""Device milliseconds of the kernels launched inside the split collide's
span (``px.collide``, ``engine/batched.py:physics_core``) a fleet step, in
the loop, over the span reader's stretch (``portbench/spans.py``).
Nothing to read on the fused step, whose collide is inside its kernel."""

from portbench import spans


def read(traced):
    rec = spans.of(traced)
    if rec is None or "px.collide" not in rec.host_s:
        return None
    return 1e3 * rec.kernel_s.get("px.collide", 0.0) / rec.steps
