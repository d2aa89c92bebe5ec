"""Synthetic multi-view video dataset for tests, smoke runs and benchmarks.

Counterpart of `dimo_tpu/io/synthetic.py`: the same numpy
`RandomState(seed)` scene (a blob of Gaussians waving under a smooth
per-motion displacement field), rendered from orbit cameras with the
port's dense compositor (`rasterize_dense`). Images agree with the JAX
package's within one uint8 level (the float -> uint8 cast truncates, so a
last-bit difference at a level boundary shows as a step of 1).
"""
from __future__ import annotations

import numpy as np
import torch

from dimo_tpu_torch.ops.rasterizer import rasterize_dense
from dimo_tpu_torch.utils import cameras
from dimo_tpu_torch.utils.general import resolve_device


@torch.no_grad()
def make_synthetic_videos(
    num_motions: int = 2,
    num_views: int = 3,
    num_frames: int = 5,
    ref_size: int = 64,
    n_gauss: int = 60,
    seed: int = 0,
    fovy_deg: float = 49.1,
    radius: float = 2.0,
    device="cuda",
):
    """Returns (images u8 (M,V,F,S,S,3), masks u8 (M,V,F,S,S), meta dict),
    numpy arrays on the host; the renders run on `device`."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    means = rng.uniform(-0.4, 0.4, (n_gauss, 3)).astype(np.float32)
    scales = torch.full((n_gauss, 3), 0.06, device=dev)
    quats = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(n_gauss, 1)
    opac = torch.full((n_gauss, 1), 0.95, device=dev)
    sh = torch.from_numpy(
        rng.uniform(-0.8, 0.8, (n_gauss, 1, 3)).astype(np.float32)).to(dev)

    fov = np.deg2rad(fovy_deg)
    azimuths = [360.0 / num_views * v for v in range(num_views)]
    cams = [cameras.Camera.from_c2w(cameras.orbit_camera(0, az, radius),
                                    fov, fov) for az in azimuths]
    bg = torch.ones(3, device=dev)

    images = torch.zeros((num_motions, num_views, num_frames, ref_size,
                          ref_size, 3), dtype=torch.uint8, device=dev)
    masks = torch.zeros((num_motions, num_views, num_frames, ref_size,
                         ref_size), dtype=torch.uint8, device=dev)
    for m in range(num_motions):
        amp = 0.15 * (m + 1)
        for f in range(num_frames):
            t = f / num_frames
            # smooth per-point displacement varying with motion index
            disp = amp * np.stack([
                np.sin(2 * np.pi * t + 3 * means[:, 1]),
                np.cos(2 * np.pi * t + 2 * means[:, 0] + m),
                np.zeros(n_gauss),
            ], axis=1).astype(np.float32)
            pts = torch.from_numpy(means + disp).to(dev)
            for v in range(num_views):
                out = rasterize_dense(pts, scales, quats, opac, sh, cams[v],
                                      ref_size, ref_size, bg)
                img = out.image.clamp(0, 1).permute(1, 2, 0)
                images[m, v, f] = (img * 255).to(torch.uint8)
                masks[m, v, f] = (out.alpha[0].clamp(0, 1) * 255).to(torch.uint8)

    meta = {
        "azimuths": azimuths,
        "full_azimuths": [360.0 / num_frames * f for f in range(num_frames)],
        "elevations": [0.0] * num_views,
        "input_videos": [f"motion_{m:02d}" for m in range(num_motions)],
        "fovy_deg": fovy_deg,
        "radius": radius,
    }
    return images.cpu().numpy(), masks.cpu().numpy(), meta
