"""JAX's counter-based PRNG, written out from its published definition.

A key is two 32-bit words; every draw is Threefry-2x32 (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011: 20 rounds, key
schedule with the parity word 0x1BD11BDA) applied to counters.  JAX's
partitionable layout (its default since 0.5) feeds the counter of flat
element ``i`` as the pair ``(hi, lo) = (0, i)``:

* ``split(key, n)``: element ``i`` is the key ``threefry(key, (0, i))``;
* 32-bit random bits of element ``i``: the two output words XOR-ed;
* ``uniform(key, shape, lo, hi)``: the top 23 bits as the mantissa of a
  float in [1, 2), minus 1, times ``hi - lo``, plus ``lo`` in one fused
  multiply-add (one rounding, as XLA compiles it), and at least ``lo``.

Words are held in int64 tensors (the benchmark's key layout, ``[..., 2]``).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words ``(x0, x1)`` under the key words
    ``(k0, k1)``; all int64 tensors holding 32-bit words, broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _counters(key, n):
    """``(k0, k1, hi, lo)`` broadcast to ``key.shape[:-1] + (n,)``."""
    k0 = key[..., 0:1]
    k1 = key[..., 1:2]
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return k0, k1, torch.zeros_like(lo), lo


def split(key, n: int = 2):
    """``[..., 2]`` keys -> ``[..., n, 2]`` keys."""
    a, b = threefry2x32(*_counters(key, n))
    return torch.stack([a, b], dim=-1)


def bits32(key, n: int):
    """``[..., 2]`` keys -> ``[..., n]`` 32-bit words (flat elements 0..n-1)."""
    a, b = threefry2x32(*_counters(key, n))
    return a ^ b


def unit_floats(key, n: int):
    """``[..., 2]`` keys -> ``[..., n]`` float32 draws in ``[0, 1)``: the top
    23 bits of each word as the mantissa of a float in [1, 2), minus 1."""
    mant = (bits32(key, n) >> 9) | 0x3F800000  # under 2**31: fits int32 as it is
    return mant.to(torch.int32).view(torch.float32) - 1.0


def scaled(f, lo: float, hi: float):
    """Unit draws to ``[lo, hi)``: ``f * (hi - lo) + lo`` rounded once, as a
    fused multiply-add (``f * (hi - lo)`` is exact in float64), at least
    ``lo``."""
    lo32 = torch.tensor(lo, dtype=torch.float32)
    span = torch.tensor(hi, dtype=torch.float32) - lo32
    fused = (f.double() * span.double().item() + lo32.double().item()).float()
    return torch.maximum(lo32.to(f.device), fused)


def uniform(key, n: int, lo: float, hi: float):
    """``[..., 2]`` keys -> ``[..., n]`` float32 draws in ``[lo, hi)``."""
    return scaled(unit_floats(key, n), lo, hi)
