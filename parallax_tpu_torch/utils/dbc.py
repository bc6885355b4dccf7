"""Design-by-contract runtime checks on tensors.

The port of ``utils/dbc.py``: pre/post-conditions, class invariants and
value sanitizers on tensors, with the JAX package's two switches.

* Checks are gated by a global debug flag (``set_debug_checks``,
  ``PARALLAX_DEBUG_CHECKS=1``); switched off, a check is an identity
  pass-through: no op runs and nothing syncs with the device.
* Switched on, a violation poisons the offending worlds with NaN.  With
  raising on (the default, ``set_raise_on_violation``,
  ``PARALLAX_CHECKS_RAISE``) the check reads its verdict on the host and
  raises ``AssertionError``: one sync a check, which is what debug mode
  is for.  Fleets switch raising off and rely on poison ->
  watchdog -> reset: one bad world of 8192 must not stop the others, and
  the env's NaN watchdog (``envs/base.py``, ``envs/plane_env.py``)
  truncates and resets just that world.

Poisoning semantics: ``check(cond, msg, *tensors)`` treats ``cond`` as a
per-world validity mask whose axes align with each tensor's *leading* axes
(the batch-major convention of the env layer).  Failing worlds of every
float tensor are replaced with NaN in the returned value(s); integer and
bool tensors pass through (NaN has no integer encoding: the float state is
what the watchdog reads).  Every violation, including predicate-only
pre/post-conditions that carry nothing to poison, is counted in a
host-side log, ``violations()``/``violation_counts()``.  In fleet mode the
counts stay on the device until that log is read (no sync a check).
"""

from __future__ import annotations

import collections
import functools
import os
from typing import Callable

import numpy as np
import torch

_DEBUG = os.environ.get("PARALLAX_DEBUG_CHECKS", "0") == "1"
_RAISE = os.environ.get("PARALLAX_CHECKS_RAISE", "1") == "1"

# The host-side violation log: message -> times violated.  A Counter, not
# a list: a systematically violated contract in a long soak adds one entry
# per distinct message, not one per call.
_VIOLATIONS: collections.Counter = collections.Counter()
# fleet mode's counts not read yet: message -> int tensor on the device
_PENDING: dict = {}


def _flush() -> None:
    for message, count in _PENDING.items():
        n = int(count)
        if n:
            _VIOLATIONS[message] += n
    _PENDING.clear()


def violations() -> tuple:
    """Distinct messages of every contract violated since the last clear
    (reads fleet mode's pending counts from the device)."""
    _flush()
    return tuple(_VIOLATIONS)


def violation_counts() -> dict:
    """``{message: times violated}`` since the last clear."""
    _flush()
    return dict(_VIOLATIONS)


def clear_violations() -> None:
    _PENDING.clear()
    _VIOLATIONS.clear()


def checks_enabled() -> bool:
    return _DEBUG


def set_debug_checks(enabled: bool) -> None:
    global _DEBUG
    _DEBUG = enabled


def set_raise_on_violation(enabled: bool) -> None:
    """Raise on the host at a violation (debugging) vs. poison only (fleets)."""
    global _RAISE
    _RAISE = enabled


def poison_where(bad, *tensors):
    """NaN-poison the worlds of each float tensor where ``bad`` is True.

    ``bad``'s axes align with each tensor's leading axes (batch-major);
    trailing axes broadcast.  Non-float tensors pass through unchanged.
    Returns a single tensor for one input, else a tuple.
    """
    bad = torch.as_tensor(bad)
    out = []
    for a in tensors:
        a = torch.as_tensor(a)
        if not a.is_floating_point():
            out.append(a)
            continue
        b = bad.reshape(bad.shape + (1,) * (a.ndim - bad.ndim)) if a.ndim > bad.ndim else bad
        out.append(torch.where(b.to(a.device), float("nan"), a))
    return out[0] if len(out) == 1 else tuple(out)


def _report(cond, message: str) -> None:
    cond = torch.as_tensor(cond)
    if _RAISE:
        if not bool(cond.all()):  # the one sync of a check in debug mode
            _VIOLATIONS[message] += 1
            raise AssertionError(f"parallax contract violated: {message}")
        return
    bad = (~cond.all()).to(torch.int64)
    _PENDING[message] = _PENDING[message] + bad if message in _PENDING else bad


def check(cond, message: str, *tensors):
    """Contract check: poison failing worlds, optionally raise on the host.

    ``cond`` is a per-world validity mask (True = ok) aligned with each
    tensor's leading axes; a scalar cond guards whole tensors.  With debug
    checks off this returns ``tensors`` (one tensor, a tuple, or None)
    untouched.  On: failing worlds of float tensors come back NaN-poisoned
    (the env's watchdog then truncates and resets just those worlds), and
    with raising on an ``AssertionError`` is raised on the host.
    """
    if not tensors:
        out = None
    elif len(tensors) == 1:
        out = tensors[0]
    else:
        out = tuple(tensors)
    if not _DEBUG:
        return out
    if tensors:
        out = poison_where(~torch.as_tensor(cond), *tensors)
    _report(cond, message)
    return out


def pre_condition(predicate: Callable, message: str = ""):
    """Check a predicate over the function's inputs before the call."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if _DEBUG:
                check(predicate(*args, **kwargs), message or f"pre_condition of {fn.__name__}")
            return fn(*args, **kwargs)

        return wrapped

    return deco


def post_condition(predicate: Callable, message: str = "", provide_input: bool = False):
    """Check a predicate over the function's output (optionally inputs too)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if _DEBUG:
                ok = predicate(out, *args, **kwargs) if provide_input else predicate(out)
                check(ok, message or f"post_condition of {fn.__name__}")
            return out

        return wrapped

    return deco


def _check_fields(self, cls) -> None:
    """Per-field annotation checks: a plain-class annotation is enforced
    with ``isinstance`` (typing constructs are skipped), and every float
    array field is checked finite."""
    anns = {}
    for klass in reversed(cls.__mro__):
        anns.update(getattr(klass, "__annotations__", {}))
    for name, ann in anns.items():
        if not hasattr(self, name):
            continue
        val = getattr(self, name)
        is_array = isinstance(val, (torch.Tensor, np.ndarray))
        if isinstance(ann, type) and not is_array:
            ok = isinstance(val, ann) or (
                ann in (float, int) and isinstance(val, (int, float, np.floating, np.integer))
            )
            if not ok:
                raise TypeError(
                    f"{cls.__name__}.{name}: expected {ann.__name__}, "
                    f"got {type(val).__name__}"
                )
        if is_array:
            t = torch.as_tensor(val)
            if t.is_floating_point():
                check(torch.isfinite(t).all(), f"{cls.__name__}.{name} is finite")


def class_invariant(cls):
    """Class decorator: before every public method call, check
    ``__invariant__(self)`` plus every annotated field (type conformance
    for plain-class annotations, finiteness for float array fields).
    A no-op unless debug checks are on.
    """
    if not hasattr(cls, "__invariant__"):
        raise TypeError(f"{cls.__name__} needs an __invariant__ method")

    def wrap(fn):
        @functools.wraps(fn)
        def checked(self, *args, **kwargs):
            if _DEBUG:
                _check_fields(self, cls)
                check(self.__invariant__(), f"invariant of {cls.__name__}")
            return fn(self, *args, **kwargs)

        return checked

    for name, attr in list(vars(cls).items()):
        if name.startswith("_") or not callable(attr):
            continue
        setattr(cls, name, wrap(attr))
    return cls
