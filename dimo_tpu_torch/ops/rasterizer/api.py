"""Gaussian-splat rendering: the public rasterizer API (forward).

Counterpart of `dimo_tpu/ops/rasterizer/api.py::rasterize`: one pass
composites RGB + depth + normal + alpha (channels=7), or RGB only
(channels=3) / RGB + depth (channels=4) through the early-exit variant.
Projection, binning and the coefficient table are plain tensor ops; the
compositing is kernel K1 (`composite_strips.py`) on the card.
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
    channels: int = 7,
) -> RenderOutput:
    """Render N Gaussians through the strip compositor.

    Args:
      means3d (N,3); scales (N,3) linear; quats (N,4); opacities (N,1)
        activated in [0,1]; sh_coeffs (N,K,3); all on one device.
      camera: utils.cameras.Camera (numpy), converted here.
      bg: (3,) background color.
      valid: (N,) bool mask for padded slots.
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

    h_pad = _round_up(height, strips_mod.STRIP_H)
    w_pad = _round_up(width, strips_mod.BUF_W)
    # `capacity` is the per-pixel depth budget of a strip list, clamped:
    # a strip can never hold more entries than gaussians exist
    cs = max(8, min(capacity, _round_up(means3d.shape[0], 8)))

    lists = strips_mod.build_strip_lists(
        p.mean2d.detach(), p.cull_radius, p.depth.detach(),
        p.in_frustum, h_pad, w_pad, cs)
    table = strips_mod.coef_table(
        p.mean2d, p.conic, opacities, p.color, p.depth, p.normal,
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
