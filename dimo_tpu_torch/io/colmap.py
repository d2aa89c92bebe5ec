"""COLMAP-style camera/scene helpers (copy of `dimo_tpu/io/colmap.py`).

The reference ships (but never imports in its mains) a set of scene-ingest
helpers: a CameraInfo record, NeRF++-style scene normalization, a uniform
orbit-pose generator, and a video-NVS camera list. Kept here for
dataset interop completeness.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from dimo_tpu_torch.utils import cameras


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray          # (3,3) rotation (c2w rotation, COLMAP convention)
    T: np.ndarray          # (3,) translation (w2c translation)
    fovx: float
    fovy: float
    width: int
    height: int
    image_path: str = ""
    image_name: str = ""


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * np.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * np.arctan(pixels / (2 * focal))


def get_world2view(R: np.ndarray, t: np.ndarray, translate=None,
                   scale: float = 1.0) -> np.ndarray:
    """(R, t) -> 4x4 world-to-view with optional recentering/scaling."""
    Rt = np.zeros((4, 4), np.float32)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        c2w = np.linalg.inv(Rt)
        cam_center = c2w[:3, 3]
        cam_center = (cam_center + (translate if translate is not None else 0)) * scale
        c2w[:3, 3] = cam_center
        Rt = np.linalg.inv(c2w)
    return Rt.astype(np.float32)


def get_nerfpp_norm(cam_infos: list[CameraInfo]) -> dict:
    """NeRF++ scene normalization: translate to camera centroid, radius =
    1.1 * max distance (reference getNerfppNorm semantics)."""
    centers = []
    for cam in cam_infos:
        w2c = get_world2view(cam.R, cam.T)
        c2w = np.linalg.inv(w2c)
        centers.append(c2w[:3, 3])
    centers = np.stack(centers)
    avg = centers.mean(axis=0)
    dists = np.linalg.norm(centers - avg, axis=1)
    radius = float(dists.max()) * 1.1
    return {"translate": -avg, "radius": radius}


def uniform_orbit_poses(n: int, radius: float = 2.0, elevation: float = 0.0
                        ) -> list[np.ndarray]:
    """n c2w poses uniformly spaced in azimuth."""
    return [cameras.orbit_camera(elevation, 360.0 / n * i, radius)
            for i in range(n)]


def video_nvs_cameras(num_frames: int, width: int, height: int,
                      fovy: float, radius: float = 2.0,
                      elevation: float = 0.0, orbit: bool = True
                      ) -> list[cameras.Camera]:
    """Camera list for novel-view-synthesis video rendering: fixed or
    one-full-orbit over the frame sequence."""
    fovx = 2 * np.arctan(np.tan(fovy / 2))
    cams = []
    for i in range(num_frames):
        azi = 360.0 / num_frames * i if orbit else 0.0
        pose = cameras.orbit_camera(elevation, azi, radius)
        cams.append(cameras.Camera.from_c2w(pose, fovx, fovy))
    return cams
