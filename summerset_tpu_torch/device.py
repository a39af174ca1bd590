"""The device rule every entry point of the port follows."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card present
    raises instead of silently running on the CPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA card is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
