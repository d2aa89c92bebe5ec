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


def train_batch(params, shape, res: int, device) -> dict:
    """`scripts/bench_train.py`'s batch: cameras at RandomState(0)
    azimuths, radius 2, fov 33.9 deg; times, motion-major latent
    indices, unit MSE weights, random uint8 GT at 512^2, zero guidance."""
    n_m, n_v, n_f = shape
    b = n_m * n_v * n_f
    rng = np.random.RandomState(0)
    fov = float(np.deg2rad(33.9))
    cams = [cameras.Camera.from_c2w(
        cameras.orbit_camera(0, rng.uniform(0, 360), 2.0), fov, fov)
        for _ in range(b)]
    dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {
        "camera": cams,
        "times": rng.rand(b).astype(np.float32),
        "latent_idx": np.repeat(np.arange(n_m), n_v * n_f).astype(np.int32),
        "mse_w": torch.ones(b, device=device),
        "gt_image": dev(rng.randint(0, 255, (b, res, res, 3), np.uint8)),
        "gt_mask": dev(rng.randint(0, 255, (b, res, res), np.uint8)),
        "guidance": torch.zeros((b, params.c_xyz.shape[0], 3), device=device),
    }


def move_timenet(params, seed: int) -> None:
    """Give TimeNet's zero-initialised output layers seeded weights, so the
    control points move and a latent fit has a gradient."""
    rng = np.random.RandomState(seed)
    net = params.timenet
    with torch.no_grad():
        for lin in (net.pts_1, net.rot_1):
            lin.weight.copy_(torch.from_numpy(
                (0.02 * rng.randn(*lin.weight.shape)).astype(np.float32)))
