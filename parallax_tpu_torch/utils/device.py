"""The device the port's entry points run on.

They run on the GPU unless the caller asks for the CPU: ``device="cuda"``
is their default.  Without a CUDA device that default raises at once; it
never falls back to the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested (the port's default), but torch "
            "finds no CUDA device; pass device='cpu' to run on the CPU"
        )
    return dev


@functools.lru_cache(maxsize=None)
def _static(values: tuple, dtype: str, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(values, dtype=dtype), device=device)


def static_tensor(values, device) -> torch.Tensor:
    """A static index or mask table (a numpy array, a sequence) as a tensor
    on ``device``, copied there once per distinct table and device: the
    per-world step's loops read the same few tables every step."""
    a = np.asarray(values)
    return _static(tuple(a.reshape(-1).tolist()), a.dtype.str, torch.device(device)).reshape(a.shape)
