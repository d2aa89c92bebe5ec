"""TimeNet: the operations of its MLP per point, counted from shapes (8
layers of width 256 with the input concatenated after layer 4, two heads
of two layers)."""
from __future__ import annotations

WIDTH, DEPTH, SKIP = 256, 8, 4


def input_dim(latent_dim: int) -> int:
    """posenc(xyz, 10 frequencies) ++ posenc(t, 6) ++ latent, without
    the raw inputs."""
    return 3 * 2 * 10 + 2 * 6 + latent_dim


def flops_per_point(latent_dim: int) -> float:
    """Forward operations of one point, 2 per multiply-add."""
    fin = input_dim(latent_dim)
    dims = [fin] + [WIDTH + fin if i - 1 == SKIP else WIDTH
                    for i in range(1, DEPTH)]
    macs = sum(d * WIDTH for d in dims) + 2 * WIDTH * WIDTH + WIDTH * (3 + 4)
    return 2.0 * macs


def flops(points: int, latent_dim: int, backward: bool) -> float:
    """Operations of `points` evaluations; a backward adds the input and
    the weight gradient, twice the forward."""
    return points * flops_per_point(latent_dim) * (3.0 if backward else 1.0)
