"""Neighbor queries on a dense distance matrix (torch).

Counterpart of the parts of `dimo_tpu/ops/neighbors.py` that the render
path and the model init use: `pairwise_sq_dists` (read by
`models/renderer.find_knn`) and `mean_sq_dist_3nn` (read by
`models/gaussians.init_model`).
"""
from __future__ import annotations

import torch


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (N, D) x (M, D) -> (N, M), through the
    |x|^2 - 2xy + |y|^2 expansion (the reference's, so ties and the
    clamp at 0 fall the same way)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)           # (N, 1)
    y2 = torch.sum(y * y, dim=-1, keepdim=True).T          # (1, M)
    xy = x @ y.T                                           # (N, M)
    return torch.clamp_min(x2 - 2.0 * xy + y2, 0.0)


def mean_sq_dist_3nn(points: torch.Tensor, chunk: int = 4096) -> torch.Tensor:
    """Mean squared distance of each point to its 3 nearest other points
    (distCUDA2 equivalent), tiled over queries."""
    n = points.shape[0]
    out = torch.empty((n,), dtype=points.dtype, device=points.device)
    for base in range(0, n, chunk):
        q = points[base:base + chunk]
        d2 = pairwise_sq_dists(q, points)
        rows = torch.arange(q.shape[0], device=points.device)
        d2[rows, base + rows] = float("inf")              # drop self
        out[base:base + chunk] = torch.topk(d2, 3, dim=1, largest=False).values.mean(-1)
    return out
