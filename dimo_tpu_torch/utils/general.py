"""Small general utilities (torch)."""
from __future__ import annotations

import torch


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's `device=` argument. Asking for
    CUDA on a machine without a card raises here, with a plain message,
    instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
