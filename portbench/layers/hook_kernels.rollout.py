"""Device kernels launched inside the env's hooks a fleet step: the spans
``px.pre`` (the action's kick), ``px.post`` (damping, reward, termination)
and ``px.obs`` (the observation) of ``envs/plane_env.py:_plane_step``,
over the span reader's stretch (``portbench/spans.py``).  Nothing to read
from a program without those spans."""

from portbench import spans

HOOKS = ("px.pre", "px.post", "px.obs")


def read(traced):
    rec = spans.of(traced)
    if rec is None or not any(h in rec.host_s for h in HOOKS):
        return None
    return sum(rec.kernels.get(h, 0) for h in HOOKS) / rec.steps
