"""Neighbor queries on a dense distance matrix (torch).

Frozen from the program's `ops/neighbors.py` (the JAX package's counterpart): `pairwise_sq_dists` (read by
`models/renderer.find_knn` and `ops/arap.py`), `mean_sq_dist_3nn` (read
by `models/gaussians.init_model`), `chamfer_forward` (the stage-2
guidance loss), `farthest_point_sampling` (the stage-1 anneal of the
control points, `models/gaussians.fps_anneal`), and `knn`, `knn_self`
and `ball_query`, which have no caller yet, as in the reference.

Self-exclusion (`knn_self`, `ball_query(exclude_self=True)`) sets the
diagonal of the distance matrix to +inf. The reference adds
`eye * inf` instead, which is NaN off the diagonal (0 * inf), so its
distances there are NaN; this is a deliberate divergence (`ROADMAP.md`
Queue C).
"""
from __future__ import annotations

import torch

from . import grad_conventions as gc


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (N, D) x (M, D) -> (N, M), through the
    |x|^2 - 2xy + |y|^2 expansion (the reference's, so ties and the
    clamp at 0 fall the same way)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)           # (N, 1)
    y2 = torch.sum(y * y, dim=-1, keepdim=True).T          # (1, M)
    xy = x @ y.T                                           # (N, M)
    return gc.maximum(x2 - 2.0 * xy + y2, 0.0)


def chamfer_forward(x: torch.Tensor, y: torch.Tensor,
                    x_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Forward chamfer: sum over x of the squared distance to the nearest
    y (chamferdist's reduction = sum). Tied nearest points share the
    gradient, as `jnp.min` splits it."""
    nearest = gc.amin(pairwise_sq_dists(x, y), dim=-1)
    if x_valid is not None:
        nearest = torch.where(x_valid, nearest, torch.zeros_like(nearest))
    return torch.sum(nearest)
