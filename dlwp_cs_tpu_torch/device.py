"""Device choice for the port's entry points.

Every entry point runs on the GPU unless its caller names another device
(the CPU tests pass ``device="cpu"``).  With no GPU and no device named it
raises: the port never carries on quietly on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``, which must
    be available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
