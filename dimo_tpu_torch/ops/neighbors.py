"""Neighbor queries on a dense distance matrix (torch).

Counterpart of `dimo_tpu/ops/neighbors.py`: `pairwise_sq_dists` (read by
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

from dimo_tpu_torch.ops import grad_conventions as gc


def pairwise_sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances (N, D) x (M, D) -> (N, M), through the
    |x|^2 - 2xy + |y|^2 expansion (the reference's, so ties and the
    clamp at 0 fall the same way)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)           # (N, 1)
    y2 = torch.sum(y * y, dim=-1, keepdim=True).T          # (1, M)
    xy = x @ y.T                                           # (N, M)
    return gc.maximum(x2 - 2.0 * xy + y2, 0.0)


def knn(queries: torch.Tensor, refs: torch.Tensor, k: int):
    """k nearest refs of each query: euclidean (not squared) distances
    (N, k) and int32 indices (N, k), nearest first. For k <= 8 by k
    rounds of argmin (the first index on ties, as the reference's)."""
    d2 = pairwise_sq_dists(queries, refs)
    if k <= 8:
        col = torch.arange(refs.shape[0], device=refs.device)[None]
        ds, ids = [], []
        for _ in range(k):
            i = torch.argmin(d2, dim=1)
            ds.append(gc.amin(d2, dim=1))
            ids.append(i)
            d2 = torch.where(col == i[:, None], torch.inf, d2)
        return (torch.sqrt(gc.maximum(torch.stack(ds, 1), 0.0)),
                torch.stack(ids, 1).to(torch.int32))
    dist, idx = torch.topk(d2, k, dim=1, largest=False)
    return torch.sqrt(gc.maximum(dist, 0.0)), idx.to(torch.int32)


def _without_self(d2: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(d2.shape[0], d2.shape[1], dtype=torch.bool,
                    device=d2.device)
    return torch.where(eye, torch.inf, d2)


def knn_self(points: torch.Tensor, k: int):
    """k nearest neighbours of each point among the others: squared
    distances (N, k) and int32 indices (N, k) (pytorch3d's
    `knn_points(..., K=k + 1)[:, 1:]`)."""
    d2 = _without_self(pairwise_sq_dists(points, points))
    dist, idx = torch.topk(d2, k, dim=1, largest=False)
    return dist, idx.to(torch.int32)


def ball_query(queries: torch.Tensor, refs: torch.Tensor, k: int,
               radius: float, exclude_self: bool = False):
    """Up to k refs strictly within `radius` of each query, nearest first:
    squared distances (N, k), 0 where padded, and int32 indices (N, k),
    -1 where padded (pytorch3d's ball_query)."""
    d2 = pairwise_sq_dists(queries, refs)
    if exclude_self:
        d2 = _without_self(d2)
    masked = torch.where(d2 < radius * radius, d2, torch.inf)
    dist, idx = torch.topk(masked, k, dim=1, largest=False)
    ok = torch.isfinite(dist)
    return (torch.where(ok, dist, torch.zeros_like(dist)),
            torch.where(ok, idx, -1).to(torch.int32))


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
