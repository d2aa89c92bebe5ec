"""Quaternion math (w, x, y, z convention) on tensors.

Frozen from the program's `ops/quat.py` (the JAX package's counterpart). All functions broadcast over
arbitrary leading batch dims.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def normalize(q: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """L2-normalize quaternions along the last axis."""
    n = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)
    return q / n


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalized quaternion(s) (..., 4) -> rotation matrix(es) (..., 3, 3)."""
    q = normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1)
    row1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1)
    row2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
