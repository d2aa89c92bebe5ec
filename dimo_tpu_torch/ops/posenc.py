"""NeRF-style sinusoidal positional encoding (torch).

Counterpart of `dimo_tpu/ops/posenc.py`: log-sampled frequencies
2^0 .. 2^(L-1), and for each frequency in ascending order the blocks
[sin(f*x), cos(f*x)] of width `input_dims`, with no raw-input passthrough
by default. Output width = 2 * L * input_dims.
"""
from __future__ import annotations

import numpy as np
import torch

from dimo_tpu_torch.utils import diagnostics


def posenc_dim(num_freqs: int, input_dims: int, include_input: bool = False) -> int:
    return (input_dims if include_input else 0) + 2 * num_freqs * input_dims


def posenc(x: torch.Tensor, num_freqs: int, include_input: bool = False) -> torch.Tensor:
    """Encode (..., D) -> (..., posenc_dim)."""
    with diagnostics.host_wait("posenc_freqs"):
        freqs = torch.from_numpy(np.exp2(np.linspace(
            0.0, num_freqs - 1, num_freqs)).astype(np.float32)).to(x.device)
    xf = x[..., None] * freqs                                  # (..., D, F)
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-1)  # (..., D, F, 2)
    enc = enc.permute(*range(enc.ndim - 3), -2, -1, -3)        # (..., F, 2, D)
    enc = enc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
