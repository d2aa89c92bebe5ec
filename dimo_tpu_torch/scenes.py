"""The flagship stage-2 scene, built on the port's own objects.

Copy of the JAX package's `__graft_entry__._flagship_scene`: the same
numpy `RandomState(seed)` draws in the same order give the same Gaussians
and control points. The TimeNet init and the latent codes come from
`torch.Generator`s (seed + 1 and seed), so those numbers differ from the
JAX scene's; carry JAX weights over with `io/convert.params_from_numpy`
where the two must agree.

The Gaussian statistics mimic a trained object model (the workload of the
reference's `test_fps` harness): points on a thick surface shell,
log-normal scales giving a few-pixel screen footprint at 512^2, and a
trained-like opacity spread (mostly opaque, long low tail).
"""
from __future__ import annotations

import numpy as np
import torch

from dimo_tpu_torch.models import gaussians as G
from dimo_tpu_torch.models.timenet import TimeNet
from dimo_tpu_torch.utils import cameras


def flagship_numpy(n_gauss=100_000, n_cpts=512, seed=0) -> dict:
    """The scene's numpy leaves, drawn exactly as the reference draws them."""
    rng = np.random.RandomState(seed)
    # thick shell: unit directions * (0.45 +- 0.04), 15% interior filler
    d = rng.randn(n_gauss, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
    r = 0.45 + rng.randn(n_gauss, 1) * 0.04
    xyz = (d * r).astype(np.float32)
    n_fill = n_gauss * 15 // 100
    xyz[:n_fill] = rng.uniform(-0.4, 0.4, (n_fill, 3)).astype(np.float32)
    log_s = (rng.randn(n_gauss, 3) * 0.4 - 5.3).astype(np.float32)
    opac_raw = (rng.randn(n_gauss, 1) * 1.5 + 1.5).astype(np.float32)
    features_dc = (rng.randn(n_gauss, 1, 3) * 0.3).astype(np.float32)
    rotation = rng.randn(n_gauss, 4).astype(np.float32)
    c_xyz = xyz[rng.choice(n_gauss, n_cpts, replace=False)]
    return {"xyz": xyz, "features_dc": features_dc, "scaling": log_s,
            "opacity": opac_raw, "rotation": rotation, "c_xyz": c_xyz}


def flagship_camera() -> cameras.Camera:
    fov = float(np.deg2rad(33.9))
    return cameras.Camera.from_c2w(cameras.orbit_camera(0, 30, 2.0), fov, fov)


def flagship_scene(n_gauss=100_000, n_cpts=512, latent_dim=32, seed=0,
                   device="cuda"):
    """(cfg, params, aux, camera) of the stage-2 flagship scene."""
    cfg = G.ModelConfig(sh_degree=0, latent_dim=latent_dim, num_latents=4,
                        capacity=n_gauss, cpt_capacity=n_cpts)
    params, aux = G._blank(cfg, device)
    dev = params.xyz.device
    leaves = flagship_numpy(n_gauss, n_cpts, seed)
    t = {k: torch.from_numpy(v).to(dev) for k, v in leaves.items()}
    codes = torch.randn((4, latent_dim),
                        generator=torch.Generator().manual_seed(seed))
    net = TimeNet(latent_dim,
                  generator=torch.Generator().manual_seed(seed + 1))
    params = params.replace(
        **t,
        c_radius=torch.full((n_cpts, 1), -3.0, dtype=torch.float32, device=dev),
        latent={"codes": codes.to(dev)},
        timenet=net.to(dev),
    )
    aux = aux.replace(active=torch.ones((n_gauss,), dtype=torch.bool, device=dev),
                      c_active=torch.ones((n_cpts,), dtype=torch.bool, device=dev))
    return cfg, params, aux, flagship_camera()
