"""``jax.random``'s threefry2x32 keys, split and uniform draws, in torch.

The lander carries its PRNG key in the state (``LanderState.key``) and
draws each world's terrain and its auto-reset keys from it, so the port
reproduces jax's bits exactly: same key in, same terrain out.  This
follows jax 0.9's defaults, ``jax_threefry_partitionable=True`` and the
``threefry2x32`` implementation (``jax/_src/prng.py``:
``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``,
``_threefry2x32_lowering``; ``jax/_src/random.py``: ``_uniform``, and
the draws the per-world random solvers consume: ``bernoulli``,
``gumbel``, ``categorical`` and ``choice``).

Keys are int64 tensors ``[..., 2]`` holding uint32 values: torch's uint32
type lacks shifts on every device, so the arithmetic runs in int64 and is
masked back to 32 bits after each add and rotate.

On CUDA key tensors ``split``, ``fold_in``, ``random_bits`` and ``uniform``
(and so the draws built on it) launch ``ops/threefry.py``'s kernels, one
launch each, with the same bits.  Their torch bodies are the plain
versions (``split_plain``, ``fold_in_plain``, ``random_bits_plain``,
``uniform_plain``) and run on CPU tensors.  The device is the only switch.
"""

from __future__ import annotations

import numpy as np
import torch

from parallax_tpu_torch.ops import threefry

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash of counters ``(x1, x2)`` under key ``(k1, k2)``.

    All four are int64 tensors of uint32 values that broadcast together.
    """
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def _counters(n: int, like):
    lo = torch.arange(n, dtype=torch.int64, device=like.device)
    return torch.zeros_like(lo), lo


def split(keys, num: int = 2):
    """``jax.random.split`` over a batch: ``[..., 2]`` -> ``[..., num, 2]``."""
    if keys.is_cuda:
        return threefry.split(keys, num)
    return split_plain(keys, num)


def split_plain(keys, num: int = 2):
    """:func:`split`'s torch body, on any device: the kernel's plain version."""
    hi, lo = _counters(num, keys)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys, data: int):
    """``jax.random.fold_in`` over a batch: ``[..., 2]`` keys and one
    uint32 ``data`` -> ``[..., 2]``, the threefry hash of the counters
    ``(0, data)`` (jax's ``threefry_seed(data)``) under each key."""
    if keys.is_cuda:
        return threefry.split(keys, 1, data)[..., 0, :]
    return fold_in_plain(keys, data)


def fold_in_plain(keys, data: int):
    """:func:`fold_in`'s torch body, on any device."""
    k1, k2 = keys[..., 0], keys[..., 1]
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(k1), torch.full_like(k1, int(data) & _MASK))
    return torch.stack([b1, b2], dim=-1)


def random_bits(keys, shape: tuple = ()):
    """``jax.random.bits`` (32-bit) over a batch: ``[..., 2]`` -> ``[..., *shape]``."""
    if keys.is_cuda:
        return threefry.random_bits(keys, shape)
    return random_bits_plain(keys, shape)


def random_bits_plain(keys, shape: tuple = ()):
    """:func:`random_bits`' torch body, on any device."""
    n = 1
    for d in shape:
        n *= d
    hi, lo = _counters(n, keys)
    b1, b2 = threefry2x32(keys[..., 0:1], keys[..., 1:2], hi, lo)
    return (b1 ^ b2).reshape(keys.shape[:-1] + tuple(shape))


def uniform(keys, shape: tuple = (), minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform`` (float32) over a batch of keys.

    Fills the mantissa of a float in [1, 2) with the top 23 random bits,
    subtracts 1 and scales, as jax does.  XLA contracts the scale and
    shift ``f * (hi - lo) + lo`` into one fused multiply-add, so it is
    computed here in float64 and rounded once to float32: the same bits
    whenever the double result is exact, which holds for bounds that are
    small integers, like every draw of the lander's terrain.
    """
    if keys.is_cuda:
        return threefry.uniform(keys, shape, *_bounds(minval, maxval))
    return uniform_plain(keys, shape, minval, maxval)


def _bounds(minval, maxval):
    """``(lo, span)``: the bounds as float32 values and their float32
    difference, kept on the host (no device copies)."""
    return float(np.float32(minval)), float(np.float32(maxval) - np.float32(minval))


def uniform_plain(keys, shape: tuple = (), minval: float = 0.0, maxval: float = 1.0):
    """:func:`uniform`'s torch body, on any device."""
    bits = random_bits_plain(keys, shape)
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo, span = _bounds(minval, maxval)
    return torch.clamp((floats.double() * span + lo).float(), min=lo)



# XLA's float32 erf_inv (chlo's ErfInv32, Giles' polynomials), which
# jax.random.normal calls: the coefficients for w = -log1p(-x^2) < 5, then
# for w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erf_inv(x):
    """XLA's float32 ``erf_inv`` of ``x`` in [-1, 1]: Giles' polynomial in
    ``w``, each Horner step one fused multiply-add as XLA on the CPU emits
    it (here in float64, rounded once).  ``torch.erfinv`` is another
    approximation (up to 61 ulps away); this one is XLA's up to its
    ``log1p`` and ``sqrt``, which XLA does not round correctly (1-2 ulps)."""
    w = -torch.log1p(x * (-x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    coef = [torch.where(small, np.float32(a).item(), np.float32(b).item()).double()
            for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p = coef[0]
    for c in coef[1:]:
        p = (c + p * w).float().double()
    r = p.float() * x
    return torch.where(x.abs() == 1, x * float("inf"), r)


def normal(keys, shape: tuple = ()):
    """``jax.random.normal`` (float32) over a batch of keys: a uniform draw
    in (-1, 1), then ``sqrt(2) * erf_inv``, as jax does; within float32
    ulps of jax's draws (see :func:`_erf_inv`)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(keys, shape, lo, 1.0)
    return np.float32(np.sqrt(2)).item() * _erf_inv(u)


# jax.random's draws on top of ``uniform``, as jax 0.9 computes them in its
# default "low" mode (``jax_high_dynamic_range_gumbel`` false; bernoulli's
# own default mode is "low" as well)
_TINY = float(np.finfo(np.float32).tiny)


def bernoulli(keys, p: float = 0.5, shape: tuple = ()):
    """``jax.random.bernoulli(key, p)``: ``uniform(key) < p``, bool."""
    return uniform(keys, shape) < float(np.float32(p))


def gumbel(keys, shape: tuple = ()):
    """``jax.random.gumbel`` (float32): ``-log(-log(u))`` of a uniform draw
    in ``[tiny, 1)``.  ``log`` is not correctly rounded on either side, so
    a draw may be an ulp or two from jax's."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY, 1.0)))


def categorical(keys, logits):
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax of ``gumbel + logits`` (the first of tied maxima).  ``keys`` is
    ``[..., 2]`` and ``logits`` ``[..., K]``, one key a distribution."""
    g = gumbel(keys, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)


def cumsum32(x):
    """A float32 running sum over the last axis, one add after another, as
    XLA's ``cumsum`` on the CPU adds them (``torch.cumsum`` may sum in
    another order or accumulate in float64)."""
    cols = [x[..., 0]]
    for k in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., k])
    return torch.stack(cols, -1)


def choice(keys, p):
    """``jax.random.choice(key, n, p=p)`` with replacement: ``p`` is
    ``[..., n]``, one key a row.  ``p_cuml = cumsum(p)``, ``r = p_cuml[-1]
    * (1 - uniform(key))``, then the first index whose ``p_cuml`` reaches
    ``r`` (``searchsorted``, left side).  A row of NaNs (``p`` of an empty
    row, 0/0) gives 0, as jax's binary search does."""
    p_cuml = cumsum32(p)
    r = p_cuml[..., -1] * (1.0 - uniform(keys))
    ind = torch.searchsorted(p_cuml.contiguous(), r[..., None].contiguous(), side="left")[..., 0]
    return torch.where(torch.isnan(r), 0, torch.clamp(ind, max=p.shape[-1] - 1))
