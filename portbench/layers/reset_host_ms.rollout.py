"""Host milliseconds inside the auto-reset's span (``px.reset``) a fleet
step, in the loop: the span's durations on the profiler's clock over the
span reader's stretch (``portbench/spans.py``), over its fleet steps."""

from portbench import spans


def read(traced):
    rec = spans.of(traced)
    if rec is None or "px.reset" not in rec.host_s:
        return None
    return 1e3 * rec.host_s["px.reset"] / rec.steps
