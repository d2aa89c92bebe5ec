"""One render of the model: TimeNet, KNN skinning (s2) or direct
deformation (s1), projection, strip lists, coefficient table, compositor.

A frozen copy of the program's render path with its kernels replaced by
plain tensor algebra: the LBS gather is indexing (`deform.py`) and the
compositor is `composite.py`. The strip lists are built from detached
means and depths, so the gradient reaches the Gaussians only through the
coefficient table.
"""
from __future__ import annotations

import torch

from . import deform
from . import grad_conventions as gc
from . import model as M
from . import neighbors
from . import quat as quat_ops
from .composite import composite
from .projection import project
from .strips import BUF_W, STRIP_H, build_strip_lists, coef_table


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@torch.no_grad()
def find_knn(params: M.Params, k: int = 4):
    """(dist, idx), (K, N): the K nearest control points of every Gaussian
    by |x|^2 - 2xy + |y|^2, lowest index first on ties."""
    d2 = neighbors.pairwise_sq_dists(params.xyz, params.c_xyz)
    col = torch.arange(params.c_xyz.shape[0], device=d2.device)[None]
    ds, ids = [], []
    for _ in range(k):
        i = torch.argmin(d2, dim=1)
        ds.append(torch.min(d2, dim=1).values)
        ids.append(i.to(torch.int32))
        d2 = torch.where(col == i[:, None], torch.inf, d2)
    return (torch.sqrt(torch.clamp_min(torch.stack(ds, 0), 0.0)),
            torch.stack(ids, 0))


def rasterize(means3d, scales, quats, opacities, sh, camera, width: int,
              height: int, bg, capacity: int, channels: int = 7,
              mean2d_tap=None, given=None):
    """dict of image (3, H, W), depth, normal, alpha, radii, overflow, the
    strip lists (`lists`), the coefficient table and the padded size
    (`pad`) of N Gaussians seen by `camera`. `given` = (idx, count)
    composites over those strip lists in place of its own."""
    dev = means3d.device
    wv, fp, cp = (torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in (camera.world_view, camera.full_proj,
                            camera.campos))
    p = project(means3d, scales, quats, opacities, sh, wv, fp, cp,
                float(camera.tan_fovx), float(camera.tan_fovy), width, height)
    mean2d = p.mean2d
    if mean2d_tap is not None:
        mean2d = mean2d + mean2d_tap * mean2d.new_tensor([0.5 * width,
                                                          0.5 * height])
    h_pad = _round_up(height, STRIP_H)
    w_pad = _round_up(width, BUF_W)
    cs = max(8, min(capacity, _round_up(means3d.shape[0], 8)))
    lists = build_strip_lists(mean2d.detach(), p.cull_radius,
                              p.depth.detach(), p.in_frustum, h_pad, w_pad,
                              cs)
    if given is not None:
        lists = lists._replace(idx=torch.as_tensor(given[0], device=dev),
                               count=torch.as_tensor(given[1], device=dev))
    table = coef_table(mean2d, p.conic, opacities, p.color, p.depth,
                       p.normal, h_pad, w_pad)
    planes = composite(table, lists.idx, lists.count, h_pad, w_pad, channels)
    out = planes[:-1, :height, :width]
    tfin = planes[-1, :height, :width]
    zeros = torch.zeros((1, height, width), dtype=out.dtype, device=dev)
    return {"image": out[0:3] + tfin[None] * bg[:, None, None],
            "depth": out[3:4] if channels >= 4 else zeros,
            "normal": out[4:7] if channels == 7 else zeros.expand(3, height,
                                                                  width),
            "alpha": (1.0 - tfin)[None], "radii": p.radius,
            "overflow": lists.overflow, "lists": lists,
            "table": table.detach(), "pad": (h_pad, w_pad)}


def render(params: M.Params, camera, time: float, stage: str,
           latent_index: int, width: int, height: int, bg,
           capacity: int, knn=None, channels: int = 7, mean2d_tap=None,
           given=None):
    """One (camera, time, motion) job; `knn` from `find_knn` (s2);
    `given` strip lists as `rasterize` takes them."""
    latent = params.latent["codes"][latent_index]
    opacity = M.get_opacity(params)
    scales = M.get_scaling(params, stage)
    if stage >= "s2":
        c_base = params.c_xyz
        d_xyz, d_rot = params.timenet(c_base, time, latent)
        cpts_t = c_base + d_xyz
        nn_dist, nn_idx = knn if knn is not None else find_knn(params)
        means3d, rotations = deform.lbs_blend(
            params.xyz, params.rotation, c_base, d_xyz, d_rot,
            M.get_c_radius(params, stage), nn_idx, nn_dist)
    else:
        d_xyz, _ = params.timenet(params.xyz, time, latent)
        means3d = params.xyz + d_xyz
        cpts_t = means3d
        rotations = quat_ops.normalize(params.rotation)
    out = rasterize(means3d, scales, rotations, opacity,
                    M.get_features(params), camera, width, height, bg,
                    capacity, channels, mean2d_tap, given)
    out["image"] = gc.clip(out["image"], 0.0, 1.0)
    out["cpts_t"] = cpts_t
    return out
