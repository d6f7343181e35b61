"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` and defaults to CUDA.
Asking for CUDA on a machine without a card raises: no code path moves
to the CPU because it found no GPU.  Tests ask for ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is CUDA and no
    CUDA device is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch sees no CUDA device "
            "(pass device='cpu' to run the plain PyTorch path)")
    return dev
