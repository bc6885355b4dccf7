"""Env states and TimeSteps passed between the JAX package and the port.

A state travels as ``{field: numpy array}``, the form of the port's
``utils/convert.py`` (``bodies.pos``, ..., ``key`` uint32): JAX's flax
states are flattened into it with :func:`state_dict`, rebuilt from it with
:func:`jax_state`, and the port's come from ``convert.*_state_from_numpy``.
"""

import jax.numpy as jnp
import numpy as np
import torch

BODY_FIELDS = ("pos", "vel", "angle", "omega")


def keys_np(batch, seed):
    """``[batch, 2]`` uint32 threefry keys from a numpy seed."""
    return np.random.default_rng(seed).integers(0, 2**32, (batch, 2), dtype=np.uint32)


def port_keys(k):
    return torch.from_numpy(np.asarray(k).astype(np.int64))


def state_dict(jstate) -> dict:
    """A JAX env state (flax struct) -> ``{field: numpy array}``."""
    d = {}
    for f in jstate.__dataclass_fields__:
        v = getattr(jstate, f)
        if f == "bodies":
            d.update({f"bodies.{g}": np.asarray(getattr(v, g)) for g in BODY_FIELDS})
        else:
            d[f] = np.asarray(v)
    return d


def jax_state(jlike, d: dict):
    """``d`` (see :func:`state_dict`) as a JAX state of ``jlike``'s type."""
    bodies = jlike.bodies.replace(**{g: jnp.asarray(d[f"bodies.{g}"]) for g in BODY_FIELDS})
    rest = {f: jnp.asarray(d[f]) for f in jlike.__dataclass_fields__ if f != "bodies"}
    return jlike.replace(bodies=bodies, **rest)


def jax_state_of(cls, d: dict):
    """``d`` (see :func:`state_dict`) as a JAX state of the flax class ``cls``."""
    from parallax_tpu.dynamics.bodies import BodyState

    bodies = BodyState(**{g: jnp.asarray(d[f"bodies.{g}"]) for g in BODY_FIELDS})
    rest = {f: jnp.asarray(d[f]) for f in cls.__dataclass_fields__ if f != "bodies"}
    return cls(bodies=bodies, **rest)


def np_tree(tree):
    """Tensors and jax arrays of a TimeStep (NamedTuple, flax struct, dict)
    -> a dict of numpy arrays keyed by their path."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}{k}.", v)
        elif hasattr(x, "_fields"):
            for k in x._fields:
                walk(f"{prefix}{k}.", getattr(x, k))
        elif hasattr(x, "__dataclass_fields__"):
            for k in x.__dataclass_fields__:
                walk(f"{prefix}{k}.", getattr(x, k))
        elif x is not None:
            out[prefix[:-1]] = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    walk("", tree)
    return out


def hold(got: dict, want: dict, bars: dict, default=0.0, what=""):
    """Every key of ``want`` in ``got``: bool and integer arrays equal, float
    arrays within ``bars[key]`` (else ``default``) absolute."""
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, f"{what} {k}: shape {g.shape} != {w.shape}"
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                          err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=bars.get(k, default),
                                       err_msg=f"{what} {k}")
