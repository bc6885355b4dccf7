"""threefry2x32's split and draws, and the lander's terrain sampler, as CUDA kernels.

``csrc/threefry.cu`` runs ``utils/prng.py``'s ``split`` (and ``fold_in``),
``random_bits`` and ``uniform`` as one launch each, one thread per output
key or value, and ``csrc/lander_terrain.cu`` runs
``envs/lunar_lander.py:terrain_planes_batch`` whole as one more, one
thread per world; the torch bodies there are their plain versions, with
the same bits.  ``prng`` and ``terrain_planes_batch`` launch these for CUDA key
tensors and run their torch bodies for CPU ones: the device is the only
switch, and a CUDA tensor gets the kernel or an exception.

Keys are int64 ``[..., 2]`` tensors of uint32 values.  The kernels read
them in place through one row stride: the two words of a key adjacent
(stride 1) and the leading axes flattening to rows one stride apart, as
any slice ``split[..., i, :]`` of a split does; another layout or dtype
raises.  Outputs are new contiguous tensors.  ``split_launches``,
``uniform_launches`` (``random_bits`` included) and ``terrain_launches``
count the launches themselves.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches in this process (see module docstring)
split_launches = 0
uniform_launches = 0
terrain_launches = 0

_MASK = 0xFFFFFFFF


def _rows(keys) -> tuple:
    """``(row stride, rows)`` of ``keys`` ``[..., 2]``; raise on what the
    kernels do not take."""
    if keys.dtype != torch.int64 or keys.dim() == 0 or keys.shape[-1] != 2:
        raise ValueError(f"threefry: keys must be int64 [..., 2], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if keys.numel() == 0:
        return 2, 0
    if keys.stride(-1) != 1:
        raise ValueError(f"threefry: a key's two words must be adjacent, strides {keys.stride()}")
    axes = [(n, s) for n, s in zip(keys.shape[:-1], keys.stride()[:-1]) if n != 1]
    for (_, outer), (n, inner) in zip(axes, axes[1:]):
        if outer != inner * n:
            raise ValueError("threefry: the keys' leading axes are not rows of one stride, "
                             f"shape {tuple(keys.shape)}, strides {keys.stride()}")
    return (axes[-1][1] if axes else 2), keys.numel() // 2


def _launch(name, fn, keys, *args):
    err = fn(ctypes.c_void_p(keys.data_ptr()), *args,
             ctypes.c_void_p(torch.cuda.current_stream(keys.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def split(keys, num: int = 2, first: int = 0):
    """``[..., 2]`` -> ``[..., num, 2]``: key ``i`` of each row the hash of
    the counters ``(0, first + i)`` (``prng.split``; ``prng.fold_in`` is
    ``num`` 1 and ``first`` its data)."""
    global split_launches
    from parallax_tpu_torch.ops import _build

    stride, N = _rows(keys)
    out = torch.empty(keys.shape[:-1] + (num, 2), dtype=torch.int64, device=keys.device)
    if out.numel() == 0:
        return out
    _launch("threefry_split", _build.load().threefry_split, keys, stride, N, num,
            int(first) & _MASK, ctypes.c_void_p(out.data_ptr()))
    split_launches += 1
    return out


def _draw(keys, shape, raw: bool, lo: float = 0.0, span: float = 0.0):
    global uniform_launches
    from parallax_tpu_torch.ops import _build

    stride, N = _rows(keys)
    n = 1
    for d in shape:
        n *= int(d)
    dtype = torch.int64 if raw else torch.float32
    out = torch.empty(keys.shape[:-1] + tuple(shape), dtype=dtype, device=keys.device)
    if out.numel() == 0:
        return out
    _launch("threefry_uniform", _build.load().threefry_uniform, keys, stride, N, n,
            float(lo), float(span), int(raw), ctypes.c_void_p(out.data_ptr()))
    uniform_launches += 1
    return out


def random_bits(keys, shape: tuple = ()):
    """``[..., 2]`` -> int64 ``[..., *shape]``: value ``i`` of each row the
    bits ``b1 ^ b2`` of the counters ``(0, i)`` (``prng.random_bits``)."""
    return _draw(keys, shape, True)


def uniform(keys, shape: tuple, lo: float, span: float):
    """``[..., 2]`` -> float32 ``[..., *shape]`` in ``[lo, lo + span)``, with
    ``lo`` and ``span`` the float32 values ``prng.uniform`` computes."""
    return _draw(keys, shape, False, lo, span)


def lander_terrain(keys, split_first: bool, V: int):
    """``keys`` ``[B, 2]`` -> ``(tox, toy)`` float32 ``[7, V, B]``: the lander's
    terrain planes of each key (``terrain_planes_batch``), or of its first
    split where ``split_first``."""
    global terrain_launches
    from parallax_tpu_torch.ops import _build

    if keys.dim() != 2:
        raise ValueError(f"lander_terrain: keys must be [B, 2], got {tuple(keys.shape)}")
    stride, B = _rows(keys)
    tox, toy = (torch.empty((7, V, B), dtype=torch.float32, device=keys.device)
                for _ in range(2))
    if B == 0:
        return tox, toy
    _launch("lander_terrain", _build.load().lander_terrain, keys, stride, B,
            int(bool(split_first)), V, ctypes.c_void_p(tox.data_ptr()),
            ctypes.c_void_p(toy.data_ptr()))
    terrain_launches += 1
    return tox, toy
