"""JAX's gradient conventions at kinks and ties, for the port's gradient paths.

The forward values are PyTorch's; only the slope at the kink differs, and
a kink is hit more often than it looks: a white background composites to
exactly 1.0, flat depth gives exact zero differences, a chamfer target can
be equidistant from two points. The reference's conventions:

  * `jnp.clip(x, lo, hi)` is `minimum(maximum(x, lo), hi)`; at x == lo or
    x == hi the tie splits the cotangent, slope 0.5. `torch.clamp` passes
    all of it (slope 1). `torch.maximum`/`torch.minimum` split ties as JAX
    does, so `clip` and `maximum` here are built from them.
  * `jnp.abs` has slope +1 at 0; `torch.abs` has 0.
  * `jnp.min` over an axis splits the cotangent equally among tied
    minima; so does `torch.amin`, while `torch.min(dim=...)` gives it all
    to one index.
"""
from __future__ import annotations

import torch

from dimo_tpu_torch.utils import diagnostics


def _bound(x: torch.Tensor, v: float) -> torch.Tensor:
    """v as a tensor beside x (to a card: a copy the host waits for)."""
    with diagnostics.host_wait("kink_bound"):
        return x.new_tensor(v)


def maximum(x: torch.Tensor, lo: float) -> torch.Tensor:
    """`jnp.maximum(x, lo)` for a scalar lo: ties split the cotangent."""
    return torch.maximum(x, _bound(x, lo))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)`: slope 0.5 at x == lo and at x == hi."""
    return torch.minimum(torch.maximum(x, _bound(x, lo)), _bound(x, hi))


def abs(x: torch.Tensor) -> torch.Tensor:  # noqa: A001 (the jnp name)
    """`jnp.abs`: slope +1 at 0."""
    return torch.where(x >= 0, x, -x)


def amin(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`jnp.min(x, axis=dim)`: tied minima share the cotangent equally."""
    return torch.amin(x, dim=dim)
