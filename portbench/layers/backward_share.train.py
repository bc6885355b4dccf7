"""The train step's backward share of its host time, in percent: the host
time in ``px.train.backward`` (which holds the checkpointed segments'
recompute) over the host time in ``px.train.forward``,
``px.train.backward`` and ``px.train.update``, over the span reader's
stretch (``portbench/spans.py``)."""

from portbench import spans

PARTS = ("px.train.forward", "px.train.backward", "px.train.update")


def read(traced):
    rec = spans.of(traced)
    if rec is None or any(p not in rec.host_s for p in PARTS):
        return None
    return 100.0 * rec.host_s["px.train.backward"] / sum(rec.host_s[p] for p in PARTS)
