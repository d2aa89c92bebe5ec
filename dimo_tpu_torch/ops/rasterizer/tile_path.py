"""The tile-compositor render path: the second, independent way through the
rasterizer.

Counterpart of the sequence the reference keeps for its tile compositor in
`scripts/profile_composite.py::upto_packed` and `scripts/profile_raster.py`:

    project -> build_tile_lists -> pack_attrs -> gather_rows -> composite

`rasterize_tiles` takes `api.rasterize`'s arguments and returns its
`RenderOutput`, composed as `api.rasterize` composes it (image = rgb +
T_final * bg, alpha = 1 - T_final); `render_tiles` puts the stage-2
deformation (latent -> TimeNet -> LBS blend) in front, as
`models/renderer.py::render` does for the strip path. The renders of the
package go through strips (`api.rasterize`); this path exists so that two
compositors that share no kernel (K1/K3 there, K8/K9 here) can be held
against each other, in images and in gradients.

Differences from the strip path, all the reference's: the image must be a
whole number of 32 x 128 tiles (nothing is padded: `num_tiles` raises);
the lists hold up to `capacity` entries per TILE, a region four strips
wide, so the same capacity overflows sooner; the gradient reaches the
Gaussians through `pack_attrs` and `gather_rows`' segment sum instead of
the coefficient table.
"""
from __future__ import annotations

import torch

from dimo_tpu_torch.models import deform as deform_mod
from dimo_tpu_torch.models import gaussians as G
from dimo_tpu_torch.ops.rasterizer import projection as proj_mod
from dimo_tpu_torch.ops.rasterizer import tiles as tiles_mod
from dimo_tpu_torch.ops.rasterizer.api import RenderOutput, camera_tensors
from dimo_tpu_torch.ops.rasterizer.composite_tiles import (
    composite, composite_infer)
from dimo_tpu_torch.ops.rasterizer.gather import gather_rows


def tile_slabs(p: proj_mod.Projected, opacities: torch.Tensor, width: int,
               height: int, capacity: int):
    """Projected Gaussians -> (packed (T, C, 16) slabs, lists): the lists
    from detached means and depths, the slabs differentiable in `p`'s
    fields and the opacities (the reference's `upto_packed` from
    `project`'s output on)."""
    lists = tiles_mod.build_tile_lists(
        p.mean2d.detach(), p.cull_radius, p.depth.detach(), p.in_frustum,
        height, width, capacity)
    attrs = tiles_mod.pack_attrs(p.mean2d, p.conic, opacities, p.color,
                                 p.depth, p.normal, radius=p.cull_radius)
    return gather_rows(attrs, lists.idx), lists


def rasterize_tiles(
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
    valid: torch.Tensor | None = None,
    channels: int = 7,
) -> RenderOutput:
    """Render N Gaussians through the tile compositor. Arguments as
    `api.rasterize`; height and width must be multiples of (32, 128).
    channels 7 is differentiable; 3 and 4 go through `composite_infer`
    (forward only; depth / normal zero-filled where not composited)."""
    if channels not in (3, 4, 7):
        raise ValueError(f"channels must be 3, 4 or 7, got {channels}")
    nrows, ncols = tiles_mod.num_tiles(height, width)
    world_view, full_proj, campos = camera_tensors(camera, means3d.device)
    p = proj_mod.project(
        means3d, scales, quats, opacities, sh_coeffs,
        world_view, full_proj, campos,
        float(camera.tan_fovx), float(camera.tan_fovy), width, height,
        sh_degree=sh_degree, valid=valid)
    packed, lists = tile_slabs(p, opacities, width, height, capacity)
    counts = lists.count.reshape(nrows, ncols)
    if channels == 7:
        out, tfin = composite(packed, counts, height, width)
    else:
        out, tfin = composite_infer(packed, counts, height, width, channels)

    zeros = torch.zeros((1, height, width), dtype=out.dtype, device=out.device)
    image = out[0:3] + tfin[None] * bg[:, None, None]
    depth = out[3:4] if channels >= 4 else zeros
    normal = out[4:7] if channels == 7 else zeros.expand(3, height, width)
    alpha = (1.0 - tfin)[None]
    return RenderOutput(
        image=image, depth=depth, normal=normal, alpha=alpha,
        radii=p.radius, overflow=lists.overflow,
        overflow_max=lists.overflow_max)


def render_tiles(cfg: G.ModelConfig, params: G.GaussianParams,
                 aux: G.GaussianAux, camera, time, latent_index: int,
                 width: int, height: int, bg: torch.Tensor, knn_cache,
                 capacity: int = 512, channels: int = 7) -> RenderOutput:
    """One stage-2 (camera, time, motion) job through the tile path: the
    motion's latent -> TimeNet on the control points -> LBS blend with the
    (nn_dist, nn_idx) of `models.renderer.find_knn` -> `rasterize_tiles`."""
    latent = G.sample_latent(params, latent_index)
    d_xyz, d_rot = params.timenet(params.c_xyz, time, latent)
    nn_dist, nn_idx = knn_cache
    means3d, rotations = deform_mod.lbs_blend(
        params.xyz, params.rotation, params.c_xyz, d_xyz, d_rot,
        G.get_c_radius(params, "s2"), nn_idx, nn_dist)
    return rasterize_tiles(
        means3d, G.get_scaling(params, "s2"), rotations,
        G.get_opacity(params), G.get_features(params), camera, width, height,
        bg, sh_degree=cfg.sh_degree, capacity=capacity, valid=aux.active,
        channels=channels)
