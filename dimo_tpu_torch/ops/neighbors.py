"""Neighbor queries on a dense distance matrix (torch).

Counterpart of the parts of `dimo_tpu/ops/neighbors.py` that the render
path, the model init and the train step use: `pairwise_sq_dists` (read by
`models/renderer.find_knn` and `ops/arap.py`), `mean_sq_dist_3nn` (read
by `models/gaussians.init_model`), `chamfer_forward` (the stage-2
guidance loss) and `farthest_point_sampling` (the stage-1 anneal of the
control points, `models/gaussians.fps_anneal`).
"""
from __future__ import annotations

import torch

from dimo_tpu_torch.ops import grad_conventions as gc


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (N, D) x (M, D) -> (N, M), through the
    |x|^2 - 2xy + |y|^2 expansion (the reference's, so ties and the
    clamp at 0 fall the same way)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)           # (N, 1)
    y2 = torch.sum(y * y, dim=-1, keepdim=True).T          # (1, M)
    xy = x @ y.T                                           # (N, M)
    return gc.maximum(x2 - 2.0 * xy + y2, 0.0)


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


def chamfer_forward(x: torch.Tensor, y: torch.Tensor,
                    x_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Forward chamfer: sum over x of the squared distance to the nearest
    y (chamferdist's reduction = sum). Tied nearest points share the
    gradient, as `jnp.min` splits it."""
    nearest = gc.amin(pairwise_sq_dists(x, y), dim=-1)
    if x_valid is not None:
        nearest = torch.where(x_valid, nearest, torch.zeros_like(nearest))
    return torch.sum(nearest)


@torch.no_grad()
def farthest_point_sampling(points: torch.Tensor, k: int,
                            valid: torch.Tensor | None = None) -> torch.Tensor:
    """Iterative farthest point sampling -> (k,) int32 indices. Starts from
    the first valid index; each round takes the argmax of the running
    minimum squared distance to the chosen set, invalid slots at -inf, the
    first index on ties (as `jnp.argmax` picks). Once every valid point is
    chosen the running minimum is 0 everywhere and index 0 of the valid
    set repeats, as in the reference. No host read inside the loop."""
    n = points.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=points.device)
    neg = torch.full((n,), -torch.inf, dtype=points.dtype,
                     device=points.device)
    idxs = torch.zeros((k,), dtype=torch.int64, device=points.device)
    idxs[0] = torch.argmax(valid.to(torch.int8))
    min_d2 = torch.full((n,), torch.inf, dtype=points.dtype,
                        device=points.device)
    for i in range(1, k):
        d2 = torch.sum((points - points[idxs[i - 1]]) ** 2, dim=-1)
        min_d2 = torch.minimum(min_d2, d2)
        idxs[i] = torch.argmax(torch.where(valid, min_d2, neg))
    return idxs.to(torch.int32)
