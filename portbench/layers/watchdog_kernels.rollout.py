"""Device kernels launched inside the NaN watchdog's span (``px.watchdog``:
the finiteness reduction over every plane and the zeroing of a flagged
world's emissions) a fleet step, over the span reader's stretch
(``portbench/spans.py``)."""

from portbench import spans


def read(traced):
    rec = spans.of(traced)
    if rec is None or "px.watchdog" not in rec.host_s:
        return None
    return rec.kernels.get("px.watchdog", 0) / rec.steps
