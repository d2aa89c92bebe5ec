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

A pass (`rasterize_batch`) renders R cameras of the same Gaussians at
once along a leading render axis: projection, binning and the table run
once for the pass, the compositor once a render; `rasterize` is its
one-render case.

Spatial parallelism (`sp`, a mesh of `parallel/mesh.py::make_sp_mesh`):
projection, binning and the coefficient table are computed on every rank;
the strips are dealt to the ranks by their entry counts
(`strips.strip_owners`), each rank composites its own (the others' counts
are set to 0, so K1 and K3 leave them at once) and keeps their pixels, and
the planes are summed over ranks. Each pixel has one non-zero addend, so
the image is the unsharded one bit for bit. In the backward the
coefficient table's gradient is summed over ranks, so every rank holds
the whole render's gradient.

`rasterize_dense` is the same function through the dense O(N*P)
compositor of `oracle.py` (tiny scenes: tests and the synthetic dataset).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dimo_tpu_torch.parallel import mesh as mesh_mod
from dimo_tpu_torch.utils import diagnostics
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
    """(world_view, full_proj, campos) of a numpy Camera, or of a list of
    them stacked along a leading axis, as float32 tensors (to a card:
    three copies the host waits for)."""
    one = hasattr(camera, "world_view")
    out = []
    for name in ("world_view", "full_proj", "campos"):
        a = (getattr(camera, name) if one
             else np.stack([getattr(c, name) for c in camera]))
        with diagnostics.host_wait("camera"):
            out.append(torch.as_tensor(a, dtype=torch.float32, device=device))
    return tuple(out)


def _tapped(mean2d, mean2d_tap, width: int, height: int):
    """mean2d + tap * [0.5 W, 0.5 H]: the tap's gradient is the pixel
    gradient times 0.5 * size, the NDC-scaled dL/dmean2D convention."""
    if mean2d_tap is None:
        return mean2d
    with diagnostics.host_wait("mean2d_tap"):
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
    sp: mesh_mod.Mesh | None = None,
) -> RenderOutput:
    """Render N Gaussians through the strip compositor: `rasterize_batch`'s
    one-render case.

    Args:
      means3d (N,3); scales (N,3) linear; quats (N,4); opacities (N,1)
        activated in [0,1]; sh_coeffs (N,K,3); all on one device.
      camera: utils.cameras.Camera (numpy), converted here.
      bg: (3,) background color.
      valid: (N,) bool mask for padded slots.
      mean2d_tap: optional (N,2) zeros; see the module docstring.
      channels: 7 (rgb+depth+normal) or 3/4 for the early-exit variant
        (depth/normal outputs zero-filled where not composited).
      sp: optional mesh that shards this render's strips over its ranks
        (every rank calls with the same inputs; see the module docstring).
    """
    out = rasterize_batch(
        means3d[None], scales, quats, opacities, sh_coeffs, [camera], width,
        height, bg, sh_degree=sh_degree, capacity=capacity,
        scale_modifier=scale_modifier, override_color=override_color,
        valid=valid, mean2d_tap=mean2d_tap, channels=channels, sp=sp)
    return RenderOutput(*(x[0] for x in out))


def rasterize_batch(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh_coeffs: torch.Tensor,
    cameras,
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
    sp: mesh_mod.Mesh | None = None,
) -> RenderOutput:
    """R renders of the same N Gaussians in one pass: means3d (R,N,3),
    quats (R,N,4) or (N,4) shared, a list of R cameras that share one
    field of view, the rest as `rasterize`; mean2d_tap taps the last
    render. Returns `RenderOutput` with a leading R on every field. `sp`
    shards a pass of one render."""
    if channels not in (3, 4, 7):
        raise ValueError(f"channels must be 3, 4 or 7, got {channels}")
    r = len(cameras)
    sharded = sp is not None and sp.size > 1
    if sharded and r != 1:
        raise ValueError(f"spatial sharding takes one render, got {r}")
    fov = {(float(c.tan_fovx), float(c.tan_fovy)) for c in cameras}
    if len(fov) != 1:
        raise ValueError(f"the cameras of one pass must share a field of "
                         f"view, got (tan x, tan y) {sorted(fov)}")
    (tan_fovx, tan_fovy), = fov
    world_view, full_proj, campos = camera_tensors(cameras, means3d.device)
    p = proj_mod.project(
        means3d, scales, quats, opacities, sh_coeffs,
        world_view, full_proj, campos, tan_fovx, tan_fovy, width, height,
        sh_degree=sh_degree, scale_modifier=scale_modifier,
        override_color=override_color, valid=valid)
    mean2d = p.mean2d
    if mean2d_tap is not None:
        mean2d = torch.cat([mean2d[:-1],
                            _tapped(mean2d[-1:], mean2d_tap, width, height)])

    h_pad = _round_up(height, strips_mod.STRIP_H)
    w_pad = _round_up(width, strips_mod.BUF_W)
    # `capacity` is the per-pixel depth budget of a strip list, clamped:
    # a strip can never hold more entries than gaussians exist
    cs = max(8, min(capacity, _round_up(means3d.shape[-2], 8)))

    lists = strips_mod.build_strip_lists(
        mean2d.detach(), p.cull_radius, p.depth.detach(),
        p.in_frustum, h_pad, w_pad, cs)
    table = strips_mod.coef_table(
        mean2d, p.conic, opacities, p.color, p.depth, p.normal,
        h_pad, w_pad)

    count = lists.count
    if sharded:
        owned = strips_mod.strip_owners(count[0], cs, sp.size) == sp.rank
        count = torch.where(owned, count, torch.zeros_like(count))
        table = mesh_mod.shard_input(table, sp)
    planes = composite_strips(table, lists.idx, count, h_pad, w_pad,
                              channels)                  # (R, C+1, H, W)
    if sharded:
        nrows, ncols = strips_mod.num_strips(h_pad, w_pad)
        px = owned.reshape(nrows, ncols).repeat_interleave(
            strips_mod.STRIP_H, 0).repeat_interleave(strips_mod.STRIP_W, 1)
        planes = mesh_mod.sum_over_ranks(
            torch.where(px, planes, torch.zeros((), device=planes.device)),
            sp)
    out = planes[:, :-1, :height, :width]
    tfin = planes[:, -1, :height, :width]

    zeros = torch.zeros((r, 1, height, width), dtype=out.dtype,
                        device=out.device)
    image = out[:, 0:3] + tfin[:, None] * bg[:, None, None]
    depth = out[:, 3:4] if channels >= 4 else zeros
    normal = out[:, 4:7] if channels == 7 else zeros.expand(r, 3, height,
                                                            width)
    alpha = (1.0 - tfin)[:, None]
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
