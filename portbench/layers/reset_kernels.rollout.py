"""Device kernels launched inside the auto-reset's span (``px.reset``: the
key split, ``plane_fresh`` and the merge of fresh and live worlds) a fleet
step, over the span reader's stretch (``portbench/spans.py``)."""

from portbench import spans


def read(traced):
    rec = spans.of(traced)
    if rec is None or "px.reset" not in rec.host_s:
        return None
    return rec.kernels.get("px.reset", 0) / rec.steps
