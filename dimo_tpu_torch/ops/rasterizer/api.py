"""Gaussian-splat rendering: the public rasterizer API.

Counterpart of `dimo_tpu/ops/rasterizer/api.py::rasterize`: one pass
composites RGB + depth + normal + alpha (channels=7, differentiable), or
RGB only (channels=3) / RGB + depth (channels=4) through the forward-only
early-exit variant. Projection, binning and the coefficient table are
plain tensor ops under autograd; the compositing is kernel K1 forward and
K3 backward (`composite_strips.py`) on the card. The strip lists are
built from detached means and depths, as the reference builds them, so
the gradient reaches the Gaussians only through the coefficient table.

Densification. `mean2d_tap` is an optional zero (N, 2) tensor added to the
projected means, scaled by [0.5 W, 0.5 H]; its gradient is dL/dmean2D in
the NDC-scaled units the densifier's `densify_grad_threshold` is stated
in. The lists are built from detached means, so the tap never reaches the
binning.

`rasterize_dense` is the same function through the dense O(N*P)
compositor of `oracle.py` (tiny scenes: tests and the synthetic dataset).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dimo_tpu_torch.ops.rasterizer import projection as proj_mod
from dimo_tpu_torch.ops.rasterizer import strips as strips_mod
from dimo_tpu_torch.ops.rasterizer.composite_strips import composite_strips


class RenderOutput(NamedTuple):
    image: torch.Tensor    # (3, H, W) rgb with background blended
    depth: torch.Tensor    # (1, H, W)
    normal: torch.Tensor   # (3, H, W)
    alpha: torch.Tensor    # (1, H, W)
    radii: torch.Tensor    # (N,) screen radii (0 = invisible)
    overflow: torch.Tensor  # () dropped per-strip entries (capacity diag)
    overflow_max: torch.Tensor  # () worst single-strip drop (escalation diag)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def camera_tensors(camera, device) -> tuple:
    """(world_view, full_proj, campos) of a numpy Camera as float32 tensors."""
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                 for a in (camera.world_view, camera.full_proj, camera.campos))


def _tapped(mean2d, mean2d_tap, width: int, height: int):
    """mean2d + tap * [0.5 W, 0.5 H]: the tap's gradient is the pixel
    gradient times 0.5 * size, the NDC-scaled dL/dmean2D convention."""
    if mean2d_tap is None:
        return mean2d
    scale_vec = mean2d.new_tensor([0.5 * width, 0.5 * height])
    return mean2d + mean2d_tap * scale_vec


def rasterize(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh_coeffs: torch.Tensor,
    camera,
    width: int,
    height: int,
    bg: torch.Tensor,
    sh_degree: int = 0,
    capacity: int = 512,
    scale_modifier: float = 1.0,
    override_color: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
    mean2d_tap: torch.Tensor | None = None,
    channels: int = 7,
) -> RenderOutput:
    """Render N Gaussians through the strip compositor.

    Args:
      means3d (N,3); scales (N,3) linear; quats (N,4); opacities (N,1)
        activated in [0,1]; sh_coeffs (N,K,3); all on one device.
      camera: utils.cameras.Camera (numpy), converted here.
      bg: (3,) background color.
      valid: (N,) bool mask for padded slots.
      mean2d_tap: optional (N,2) zeros; see the module docstring.
      channels: 7 (rgb+depth+normal) or 3/4 for the early-exit variant
        (depth/normal outputs zero-filled where not composited).
    """
    if channels not in (3, 4, 7):
        raise ValueError(f"channels must be 3, 4 or 7, got {channels}")
    world_view, full_proj, campos = camera_tensors(camera, means3d.device)
    p = proj_mod.project(
        means3d, scales, quats, opacities, sh_coeffs,
        world_view, full_proj, campos,
        float(camera.tan_fovx), float(camera.tan_fovy), width, height,
        sh_degree=sh_degree, scale_modifier=scale_modifier,
        override_color=override_color, valid=valid)
    mean2d = _tapped(p.mean2d, mean2d_tap, width, height)

    h_pad = _round_up(height, strips_mod.STRIP_H)
    w_pad = _round_up(width, strips_mod.BUF_W)
    # `capacity` is the per-pixel depth budget of a strip list, clamped:
    # a strip can never hold more entries than gaussians exist
    cs = max(8, min(capacity, _round_up(means3d.shape[0], 8)))

    lists = strips_mod.build_strip_lists(
        mean2d.detach(), p.cull_radius, p.depth.detach(),
        p.in_frustum, h_pad, w_pad, cs)
    table = strips_mod.coef_table(
        mean2d, p.conic, opacities, p.color, p.depth, p.normal,
        h_pad, w_pad)

    planes = composite_strips(table, lists.idx, lists.count, h_pad, w_pad,
                              channels)
    out = planes[:-1, :height, :width]
    tfin = planes[-1, :height, :width]

    zeros = torch.zeros((1, height, width), dtype=out.dtype, device=out.device)
    image = out[0:3] + tfin[None] * bg[:, None, None]
    depth = out[3:4] if channels >= 4 else zeros
    normal = out[4:7] if channels == 7 else zeros.expand(3, height, width)
    alpha = (1.0 - tfin)[None]
    return RenderOutput(
        image=image, depth=depth, normal=normal, alpha=alpha,
        radii=p.radius, overflow=lists.overflow,
        overflow_max=lists.overflow_max)


def rasterize_dense(
    means3d, scales, quats, opacities, sh_coeffs, camera,
    width: int, height: int, bg,
    sh_degree: int = 0, scale_modifier: float = 1.0,
    override_color=None, valid=None, mean2d_tap=None,
) -> RenderOutput:
    """`rasterize` through the dense O(N*P) compositor (tests and tiny
    scenes only): same arguments, no capacity, nothing dropped."""
    from dimo_tpu_torch.ops.rasterizer import oracle

    world_view, full_proj, campos = camera_tensors(camera, means3d.device)
    p = proj_mod.project(
        means3d, scales, quats, opacities, sh_coeffs,
        world_view, full_proj, campos,
        float(camera.tan_fovx), float(camera.tan_fovy), width, height,
        sh_degree=sh_degree, scale_modifier=scale_modifier,
        override_color=override_color, valid=valid)
    p = p._replace(mean2d=_tapped(p.mean2d, mean2d_tap, width, height))
    ops = torch.where(p.in_frustum[:, None], opacities,
                      torch.zeros((), device=opacities.device))
    res = oracle.composite_dense(p, ops, bg, width, height)
    zero = torch.zeros((), dtype=torch.int32, device=means3d.device)
    return RenderOutput(
        image=res["image"].permute(2, 0, 1),
        depth=res["depth"].permute(2, 0, 1),
        normal=res["normal"].permute(2, 0, 1),
        alpha=res["alpha"].permute(2, 0, 1),
        radii=p.radius, overflow=zero, overflow_max=zero)
