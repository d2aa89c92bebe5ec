"""Small general utilities (torch)."""
from __future__ import annotations

import torch


def inverse_sigmoid(x):
    return torch.log(x / (1 - x))


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric -> (..., 6) upper triangle [xx,xy,xz,yy,yz,zz]."""
    return torch.stack(
        [cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
         cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], dim=-1)


def cudnn_tf32(allow: bool):
    """A context in which cuDNN's convolutions run with TF32 allowed or
    not, and by deterministic algorithms only (cuDNN's default pick for a
    convolution's backward may add with atomics, so two runs differed in
    their last bits), and which restores every global cuDNN flag when it
    exits. It covers what runs inside it only: a backward that autograd
    runs later sees the global flags, so a caller whose backward must keep
    the same precision and order sets it there too (an
    `autograd.Function`)."""
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=b.benchmark,
                   deterministic=True, allow_tf32=allow)


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
