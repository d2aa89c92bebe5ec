"""The trainer's batches, derived from its seed: a frozen copy of the
draw rules. Each step draws `batch_size` frames and `batch_size` views
with `random.Random(seed)` and `min(2 * batch_size, motions)` motions
with numpy's legacy generator seeded by the same seed, then renders
every (motion, view, frame), motion-major. A render's time is
frame / frames, its MSE weight 1 for view 0 or frame 0 and 0.5
elsewhere, and its camera orbits at the view's azimuth.
"""
from __future__ import annotations

import random

import numpy as np

from . import cameras

CAM_NEAR, CAM_FAR = 0.01, 100.0


def draw(seed: int, steps: int, motions: int, views: int, frames: int,
         batch_size: int) -> list:
    """[(M, V, F) rows of each step], as (motion, view, frame) tuples."""
    py = random.Random(seed)
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        fs = py.sample(range(frames), min(batch_size, frames))
        vs = py.sample(range(views), min(batch_size, views))
        ms = rng.choice(motions, min(2 * batch_size, motions), replace=False)
        out.append([(int(m), v, f) for m in ms for v in vs for f in fs])
    return out


def camera(azimuth: float, opt: dict) -> cameras.Camera:
    fovy = np.deg2rad(opt["fovy"])
    fovx = 2 * np.arctan(np.tan(fovy / 2) * opt["W"] / opt["H"])
    pose = cameras.orbit_camera(opt["elevation"], azimuth, opt["radius"])
    return cameras.Camera.from_c2w(pose, fovx, fovy, CAM_NEAR, CAM_FAR)


def batch(rows: list, opt: dict, azimuths: list, images, masks,
          guidance=None) -> dict:
    """One step's batch from the benchmark's dataset (host arrays)."""
    f_all = int(opt["num_frames"])
    m, v, f = (np.asarray(x) for x in zip(*rows))
    out = {"camera": [camera(azimuths[i], opt) for i in v],
           "times": [fi / f_all for fi in f],
           "latent_idx": m.tolist(),
           "mse_w": [1.0 if (vi == 0 or fi == 0) else 0.5
                     for vi, fi in zip(v, f)],
           "gt_image": images[m, v, f], "gt_mask": masks[m, v, f]}
    if guidance is not None:
        out["guidance"] = guidance[m, f]
    return out
