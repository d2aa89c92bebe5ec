"""The KNN of every Gaussian among the control points: the distance
matrix's product, 2 operations a multiply-add over 3 coordinates, and the
norms and sums beside it (3 more a pair)."""
from __future__ import annotations


def flops(n_gaussians: int, n_cpts: int) -> float:
    return 9.0 * n_gaussians * n_cpts
