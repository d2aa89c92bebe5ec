"""Full deformation render: TimeNet -> (s1 direct / s2 KNN-LBS) -> rasterize.

Counterpart of `dimo_tpu/models/renderer.py` (`find_knn`, `render`). The
returned dict carries the reference's render keys (image, depth, normal,
alpha, radii, visibility_filter, pts_t, cpts_t) plus `overflow` and
`overflow_max` for the strip-capacity diagnostics.

`render_batch` renders R jobs in one pass along a leading render axis
(the train step's jobs), and `render` is its one-job case (serving, the
test modes, spatial sharding). Both are differentiable (the train step
backpropagates through the pass: K3 and K4 are the backward kernels of
the compositor and the LBS gather); serving callers run `render` under
`torch.no_grad()`, so no graph is recorded. `find_knn` never carries a
gradient, as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from dimo_tpu_torch.models import deform as deform_mod
from dimo_tpu_torch.models import gaussians as G
from dimo_tpu_torch.ops import grad_conventions as gc
from dimo_tpu_torch.ops import neighbors
from dimo_tpu_torch.ops import quat as quat_ops
from dimo_tpu_torch.ops.rasterizer import (
    RenderOutput, rasterize_batch, rasterize_dense)
from dimo_tpu_torch.utils import diagnostics


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


def _timenet(net, pts, t, latents):
    """TimeNet's (d_xyz, d_rot) of R jobs, (R, M, .): the input of every job
    at once, the MLP a job at a time. Each job's weight gradient is then
    the GEMM a one-job render makes, and the jobs' sum accumulates as
    theirs does: a pass's sum over all its jobs' rows in one GEMM rounds
    otherwise, and Adam's first steps magnify that where a weight's
    gradient nearly cancels."""
    outs = [net.mlp(e) for e in net.embed(pts, t, latents)]
    return tuple(torch.stack(x) for x in zip(*outs))


def render_batch(
    cfg: G.ModelConfig,
    params: G.GaussianParams,
    aux: G.GaussianAux,
    cameras,
    times,
    stage: str,
    latent_indices,
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
    """Render R (camera, time, motion) jobs in one pass; `render`'s
    arguments with a list of R cameras, times and latent indices. Returns
    `render`'s dict with a leading R on every entry.

    Each op runs once for the pass on tensors with a leading render axis:
    the latents (VAE noise from `rng` drawn in job order), TimeNet's input
    (its MLP a job at a time, `_timenet`), the LBS blend, projection,
    binning (each render's lists as it would get them alone,
    `ops/rasterizer/tiles.py::build_bin_lists`) and the coefficient
    table. The gathers and the compositor launch once a render.
    mean2d_tap taps the LAST job's means. The cameras of a pass share one
    field of view; `sp` takes one job.
    """
    r = len(cameras)
    if r == 0 or len(times) != r or len(latent_indices) != r:
        raise ValueError(f"{r} cameras, {len(times)} times and "
                         f"{len(latent_indices)} latent indices: a pass "
                         "takes one of each a job")
    diagnostics.RECORDER.count("render_jobs", r)
    diagnostics.RECORDER.count("render_passes")
    latents = torch.stack([G.sample_latent(params, i, rng)
                           for i in latent_indices])[:, None]   # (R, 1, L)
    t = np.asarray(times, dtype=np.float64).reshape(r, 1, 1)
    opacity = G.get_opacity(params)
    scales = G.get_scaling(params, stage)

    if stage >= "s2":
        c_base = params.c_xyz
        d_xyz, d_rot = _timenet(params.timenet, c_base, t, latents)
        cpts_t = c_base + d_xyz                                 # (R, M, 3)
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
        d_xyz, _ = _timenet(params.timenet, base, t, latents)
        means3d = base + d_xyz
        cpts_t = means3d
        rotations = quat_ops.normalize(params.rotation)       # shared

    common = dict(sh_degree=cfg.sh_degree, scale_modifier=scaling_modifier,
                  override_color=override_color, valid=aux.active)
    if use_oracle:
        # the dense compositor takes one render (tests and tiny scenes)
        per = [rasterize_dense(
            means3d[i], scales, rotations if rotations.dim() == 2
            else rotations[i], opacity, G.get_features(params), cameras[i],
            width, height, bg,
            mean2d_tap=mean2d_tap if i == r - 1 else None, **common)
            for i in range(r)]
        out = RenderOutput(*(torch.stack(f) for f in zip(*per)))
    else:
        out = rasterize_batch(
            means3d, scales, rotations, opacity, G.get_features(params),
            cameras, width, height, bg, capacity=capacity,
            mean2d_tap=mean2d_tap, channels=channels, sp=sp, **common)

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
    """Render one (camera, time, motion) job: `render_batch`'s one-job
    case.

    knn_cache: optional (nn_dist, nn_idx) from find_knn, to run the KNN
    once for many renders. rng: VAE reparameterization noise (None = mean).
    mean2d_tap: zero (N, 2) tensor whose gradient is the NDC-scaled
    dL/dmean2D (`ops/rasterizer/api.py`). use_oracle: composite densely
    (`rasterize_dense`; capacity, channels and sp do not apply). sp:
    optional `parallel/mesh.py::make_sp_mesh` mesh sharding the
    compositing of this render over its ranks (`rasterize`).
    """
    out = render_batch(
        cfg, params, aux, [camera], [time], stage, [latent_index], width,
        height, bg, rng=rng, knn_cache=knn_cache,
        scaling_modifier=scaling_modifier, override_color=override_color,
        mean2d_tap=mean2d_tap, local_frame=local_frame, capacity=capacity,
        use_oracle=use_oracle, channels=channels, sp=sp)
    return {k: v[0] for k, v in out.items()}
