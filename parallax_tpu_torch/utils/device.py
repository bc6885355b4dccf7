"""The device the port's entry points run on.

They run on the GPU unless the caller asks for the CPU: ``device="cuda"``
is their default.  Without a CUDA device that default raises at once; it
never falls back to the CPU.
"""

from __future__ import annotations

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
