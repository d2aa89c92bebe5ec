"""Full deformation render: TimeNet -> (s1 direct / s2 KNN-LBS) -> rasterize.

Counterpart of `dimo_tpu/models/renderer.py` (`find_knn`, `render`). The
returned dict carries the reference's render keys (image, depth, normal,
alpha, radii, visibility_filter, pts_t, cpts_t) plus `overflow` and
`overflow_max` for the strip-capacity diagnostics.

`render` is differentiable (the train step backpropagates through it:
K3 and K4 are the backward kernels of the compositor and the LBS
gather); serving callers run it under `torch.no_grad()`, so no graph is
recorded. `find_knn` never carries a gradient, as in the reference.
"""
from __future__ import annotations

import torch

from dimo_tpu_torch.models import deform as deform_mod
from dimo_tpu_torch.models import gaussians as G
from dimo_tpu_torch.ops import grad_conventions as gc
from dimo_tpu_torch.ops import neighbors
from dimo_tpu_torch.ops import quat as quat_ops
from dimo_tpu_torch.ops.rasterizer import rasterize, rasterize_dense


@torch.no_grad()
def find_knn(params: G.GaussianParams, aux: G.GaussianAux, k: int = 4):
    """KNN of every gaussian among the active control points. Returns
    (dist, idx) in (K, N) layout, idx int32. Iterated argmin over the same
    |x|^2 - 2xy + |y|^2 distances as the reference: first index on ties."""
    c = params.c_xyz
    x = params.xyz
    d2 = neighbors.pairwise_sq_dists(x, c)
    d2 = torch.where(aux.c_active[None, :], d2, torch.inf)
    col = torch.arange(c.shape[0], device=c.device)[None]
    ds, ids = [], []
    for _ in range(k):
        i = torch.argmin(d2, dim=1)
        ds.append(torch.min(d2, dim=1).values)
        ids.append(i.to(torch.int32))
        d2 = torch.where(col == i[:, None], torch.inf, d2)
    return (torch.sqrt(torch.clamp_min(torch.stack(ds, 0), 0.0)),
            torch.stack(ids, 0))


def render(
    cfg: G.ModelConfig,
    params: G.GaussianParams,
    aux: G.GaussianAux,
    camera,
    time,
    stage: str,
    latent_index: int,
    width: int,
    height: int,
    bg: torch.Tensor,
    rng: torch.Generator | None = None,
    knn_cache=None,
    scaling_modifier: float = 1.0,
    override_color: torch.Tensor | None = None,
    mean2d_tap: torch.Tensor | None = None,
    local_frame: bool = True,
    capacity: int = 512,
    use_oracle: bool = False,
    channels: int = 7,
    sp=None,
):
    """Render one (camera, time, motion) job.

    knn_cache: optional (nn_dist, nn_idx) from find_knn, to run the KNN
    once for many renders. rng: VAE reparameterization noise (None = mean).
    mean2d_tap: zero (N, 2) tensor whose gradient is the NDC-scaled
    dL/dmean2D (`ops/rasterizer/api.py`). use_oracle: composite densely
    (`rasterize_dense`; capacity, channels and sp do not apply). sp:
    optional `parallel/mesh.py::make_sp_mesh` mesh sharding the
    compositing of this render over its ranks (`rasterize`).
    """
    latent = G.sample_latent(params, latent_index, rng)
    opacity = G.get_opacity(params)
    scales = G.get_scaling(params, stage)

    if stage >= "s2":
        c_base = params.c_xyz
        d_xyz, d_rot = params.timenet(c_base, time, latent)
        cpts_t = c_base + d_xyz
        if knn_cache is None:
            nn_dist, nn_idx = find_knn(params, aux)
        else:
            nn_dist, nn_idx = knn_cache
        c_radius = G.get_c_radius(params, stage)
        means3d, rotations = deform_mod.lbs_blend(
            params.xyz, params.rotation, c_base, d_xyz, d_rot, c_radius,
            nn_idx, nn_dist, local_frame=local_frame)
    else:
        base = params.xyz
        d_xyz, d_rot = params.timenet(base, time, latent)
        means3d = base + d_xyz
        cpts_t = means3d
        rotations = quat_ops.normalize(params.rotation)

    raster = rasterize_dense if use_oracle else rasterize
    kwargs = {} if use_oracle else {"capacity": capacity, "channels": channels,
                                    "sp": sp}
    out = raster(
        means3d, scales, rotations, opacity, G.get_features(params),
        camera, width, height, bg,
        sh_degree=cfg.sh_degree, scale_modifier=scaling_modifier,
        override_color=override_color, valid=aux.active,
        mean2d_tap=mean2d_tap, **kwargs)

    return {
        # jnp.clip's slope at 0 and 1 is 0.5: white-background pixels sit
        # at exactly 1.0
        "image": gc.clip(out.image, 0.0, 1.0),
        "depth": out.depth,
        "normal": out.normal,
        "alpha": out.alpha,
        "radii": out.radii,
        "visibility_filter": out.radii > 0,
        "pts_t": means3d,
        "cpts_t": cpts_t,
        "overflow": out.overflow,
        "overflow_max": out.overflow_max,
    }
