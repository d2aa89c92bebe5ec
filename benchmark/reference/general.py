"""Precision switches of the reference.

The reference computes in float32 with TF32 off in every matmul and
convolution. `cudnn_tf32(allow)` is the context its convolutions run in:
cuDNN's TF32 is allowed when the caller asks for it or when the process
allows TF32 in matmuls (`set_tf32(True)`, the control's lower precision),
and only deterministic algorithms are picked.
"""
from __future__ import annotations

import torch


def set_tf32(on: bool) -> None:
    """TF32 in every float32 matmul and convolution of this process."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def cudnn_tf32(allow: bool):
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=b.benchmark,
                   deterministic=True,
                   allow_tf32=allow or torch.backends.cuda.matmul.allow_tf32)
