"""Per-step metrics and host-side logging.

The port of ``utils/metrics.py``: a structured per-step info tree
(contacts count, penetration depths, rewards, resets) computed on the
device as reductions, and logged on the host only when debug logging is
on.

Usage::

    state, contacts = world.step(state)
    m = contact_metrics(contacts)          # {'n_active', 'max_depth', ...}
    log_metrics(m, step=i, every=100)      # host print, debug only

    # the batched path's batch-minor planes:
    m = contact_metrics_bm(collide_batched(world, _to_soa(batched_state)))
"""

from __future__ import annotations

from typing import Dict

import torch

from parallax_tpu_torch.geometry.math import safe_norm


def _max0(x, dim=None):
    """``jnp.max(x, initial=0.0)``: the max of ``x`` and 0, over all of
    ``x`` or over ``dim`` (0 where the reduced dim is empty)."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    zero = x.new_zeros(x.shape[:dim] + (1,) + x.shape[dim + 1:])
    return torch.cat([x, zero], dim=dim).amax(dim=dim)


def contact_metrics(contacts) -> Dict[str, torch.Tensor]:
    """Summarize a ``Contact`` buffer (any leading batch dims), reduced over
    *all* leading axes: ``n_active`` (active contact points), ``max_depth``
    (deepest penetration, 0 if none), ``mean_depth`` (over active points,
    0 if none) and ``sum_depth`` (total penetration)."""
    act = contacts.active
    depth = safe_norm(contacts.penetration, dim=-1) * act
    n = torch.sum(act)
    total = torch.sum(depth)
    return {
        "n_active": n,
        "max_depth": _max0(depth),
        "mean_depth": total / torch.clamp(n, min=1),
        "sum_depth": total,
    }


def contact_metrics_bm(contacts) -> Dict[str, torch.Tensor]:
    """The same summary of the batched path's ``ContactsBM`` planes
    (``engine/batched.py``: ``pen_x``/``pen_y``/``active`` ``[C, B]``):
    per-world ``[B]`` vectors (what a vectorized logger or curriculum
    wants) and fleet scalars."""
    act = contacts.active.to(contacts.pen_x.dtype)
    depth = torch.sqrt(contacts.pen_x**2 + contacts.pen_y**2 + 1e-30) * act
    n_w = torch.sum(act, dim=0)  # [B]
    sum_w = torch.sum(depth, dim=0)  # [B]
    return {
        "n_active_per_world": n_w,
        "max_depth_per_world": _max0(depth, 0),
        "mean_depth_per_world": sum_w / torch.clamp(n_w, min=1),
        "n_active": torch.sum(n_w),
        "max_depth": _max0(depth),
    }


def timestep_metrics(ts) -> Dict[str, torch.Tensor]:
    """Reward/reset summary of a (batched or stacked) ``TimeStep``."""
    done = ts.done.to(torch.float32)
    return {
        "mean_reward": torch.mean(ts.reward),
        "n_done": torch.sum(done),
        "reset_rate": torch.mean(done),
    }


def merge_metrics(*ms: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Left-to-right merge of metric dicts (later keys win)."""
    out: Dict[str, torch.Tensor] = {}
    for m in ms:
        out.update(m)
    return out


_DEBUG = [False]


def set_debug_logging(on: bool) -> None:
    """Globally enable :func:`log_metrics`' host print.  Off by default:
    the print reads the metrics on the host, a device sync, so it never
    sits in a production step."""
    _DEBUG[0] = bool(on)


def log_metrics(metrics: Dict[str, torch.Tensor], step=0, every: int = 1) -> None:
    """Print the scalar metrics on the host every ``every`` steps.

    A no-op (no op, no sync) unless :func:`set_debug_logging` is on.
    Vector entries (per-world planes) are skipped.
    """
    if not _DEBUG[0]:
        return
    s = int(step)
    if s % int(every) != 0:
        return
    scalars = {k: v for k, v in metrics.items() if torch.as_tensor(v).ndim == 0}
    line = " ".join(f"{k}={float(v):.6g}" for k, v in sorted(scalars.items()))
    print(f"[metrics step={s}] {line}", flush=True)
