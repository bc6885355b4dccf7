"""The share of the device's idle time, in percent, whose gaps fall inside
the auto-reset's span (``px.reset``): each gap of the span reader's
stretch (``portbench/spans.py``) belongs to the narrowest span open at its
midpoint."""

from portbench import spans


def read(traced):
    rec = spans.of(traced)
    if rec is None or "px.reset" not in rec.host_s or not rec.idle_total_s:
        return None
    return 100.0 * rec.idle_s.get("px.reset", 0.0) / rec.idle_total_s
