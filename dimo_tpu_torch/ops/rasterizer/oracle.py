"""Dense O(N*P) alpha compositor in plain tensor ops.

Counterpart of `dimo_tpu/ops/rasterizer/oracle.py`: every Gaussian at
every pixel, no culling, no lists, no early stop. It defines the
rasterizer's semantics on tiny scenes (the synthetic dataset renders its
ground truth with it) and is differentiable by autograd.

Compositing rule:
  alpha_i = min(0.99, opacity_i * exp(power_i)), skipped if < 1/255
  front-to-back: C = sum_i c_i alpha_i T_i,  T_i = prod_{j<i} (1 - alpha_j)
  image = C + T_final * bg; depth/normal/alpha composited without bg.
"""
from __future__ import annotations

import torch

from dimo_tpu_torch.ops.rasterizer.projection import Projected

ALPHA_EPS = 1.0 / 255.0
ALPHA_MAX = 0.99


def composite_dense(proj: Projected, opacities: torch.Tensor,
                    bg: torch.Tensor, width: int, height: int) -> dict:
    """Composite all Gaussians at every pixel. Returns a dict with image
    (H,W,3), depth (H,W,1), normal (H,W,3), alpha (H,W,1), t_final (H,W)."""
    dev = proj.depth.device
    order = torch.argsort(torch.where(proj.in_frustum, proj.depth.detach(),
                                      torch.inf), stable=True)
    mx = proj.mean2d[order, 0]
    my = proj.mean2d[order, 1]
    ca, cb, cc = (proj.conic[order, 0], proj.conic[order, 1],
                  proj.conic[order, 2])
    op = torch.where(proj.in_frustum[order], opacities[order, 0],
                     torch.zeros((), device=dev))
    col = proj.color[order]
    dep = proj.depth[order]
    nrm = proj.normal[order]

    ys = torch.arange(height, dtype=torch.float32, device=dev)
    xs = torch.arange(width, dtype=torch.float32, device=dev)
    py, px = torch.meshgrid(ys, xs, indexing="ij")          # (H, W)

    dx = px[None] - mx[:, None, None]                        # (N, H, W)
    dy = py[None] - my[:, None, None]
    power = -0.5 * (ca[:, None, None] * dx * dx + cc[:, None, None] * dy * dy) \
        - cb[:, None, None] * dx * dy
    alpha = torch.minimum(op[:, None, None] * torch.exp(power),
                          power.new_tensor(ALPHA_MAX))
    alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_EPS), alpha,
                        torch.zeros((), device=dev))

    one_minus = 1.0 - alpha
    T = torch.cat([torch.ones_like(alpha[:1]),
                   torch.cumprod(one_minus, dim=0)[:-1]], dim=0)
    w = alpha * T                                            # (N, H, W)
    t_final = torch.prod(one_minus, dim=0)                   # (H, W)

    rgb = torch.einsum("nhw,nc->hwc", w, col)
    depth = torch.einsum("nhw,n->hw", w, dep)[..., None]
    normal = torch.einsum("nhw,nc->hwc", w, nrm)
    image = rgb + t_final[..., None] * bg[None, None, :]
    return {"image": image, "depth": depth, "normal": normal,
            "alpha": (1.0 - t_final)[..., None], "t_final": t_final}
