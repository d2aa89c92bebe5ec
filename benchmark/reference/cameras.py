"""Camera system: orbit poses, perspective projection, rasterizer camera.

Frozen from the program's `utils/cameras.py` (numpy only). Conventions:

  * orbit poses are NeRF/OpenGL c2w matrices (camera looks down -z, y up);
  * the rasterizer camera applies the reference's axis rectification
    (flip y/z rows of w2c, negate translation) and stores matrices
    TRANSPOSED, i.e. points transform as row vectors: clip = [p, 1] @ full_proj;
  * camera_center = -c2w[:3, 3] (reference quirk, consistent with the
    rectified w2c).

`Camera` stays numpy; the render converts it to tensors on the device
of the Gaussians.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


def _safe_normalize(x, eps=1e-20):
    return x / np.sqrt(np.maximum(np.sum(x * x, axis=-1, keepdims=True), eps))


def look_at(campos: np.ndarray, target: np.ndarray, opengl: bool = True) -> np.ndarray:
    """Rotation matrix (3,3) with camera at campos looking at target."""
    if not opengl:
        forward = _safe_normalize(target - campos)
        up = np.array([0, 1, 0], dtype=np.float32)
        right = _safe_normalize(np.cross(forward, up))
        up = _safe_normalize(np.cross(right, forward))
    else:
        forward = _safe_normalize(campos - target)
        up = np.array([0, 1, 0], dtype=np.float32)
        right = _safe_normalize(np.cross(up, forward))
        up = _safe_normalize(np.cross(forward, right))
    return np.stack([right, up, forward], axis=1)


def orbit_camera(elevation: float, azimuth: float, radius: float = 1.0,
                 is_degree: bool = True, target=None, opengl: bool = True) -> np.ndarray:
    """Elevation/azimuth/radius -> (4,4) c2w pose (NeRF convention)."""
    if is_degree:
        elevation = np.deg2rad(elevation)
        azimuth = np.deg2rad(azimuth)
    x = radius * np.cos(elevation) * np.sin(azimuth)
    y = -radius * np.sin(elevation)
    z = radius * np.cos(elevation) * np.cos(azimuth)
    if target is None:
        target = np.zeros([3], dtype=np.float32)
    campos = np.array([x, y, z], dtype=np.float32) + target
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = look_at(campos, target, opengl)
    T[:3, 3] = campos
    return T


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection, z mapped to [0, zfar/(zfar-znear)] style of the
    reference's getProjectionMatrix (z_sign=+1, w = +z_view)."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1 / tan_x
    P[1, 1] = 1 / tan_y
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


class Camera(NamedTuple):
    """Rasterizer camera (MiniCam equivalent), numpy fields.

    world_view: (4,4) transposed rectified w2c; full_proj: (4,4) transposed
    world->clip; campos: (3,); tan_fovx/tan_fovy: scalars.
    """
    world_view: np.ndarray
    full_proj: np.ndarray
    campos: np.ndarray
    tan_fovx: np.ndarray
    tan_fovy: np.ndarray

    @staticmethod
    def from_c2w(c2w: np.ndarray, fovx: float, fovy: float,
                 znear: float = 0.01, zfar: float = 100.0) -> "Camera":
        w2c = np.linalg.inv(np.asarray(c2w, dtype=np.float64)).astype(np.float32)
        # reference rectification: flip y/z rows, negate translation column
        w2c[1:3, :3] *= -1
        w2c[:3, 3] *= -1
        world_view = w2c.T.astype(np.float32)
        proj = projection_matrix(znear, zfar, fovx, fovy).T
        full_proj = (world_view @ proj).astype(np.float32)
        campos = (-np.asarray(c2w, dtype=np.float32)[:3, 3]).astype(np.float32)
        return Camera(
            world_view=world_view,
            full_proj=full_proj,
            campos=campos,
            tan_fovx=np.float32(math.tan(fovx * 0.5)),
            tan_fovy=np.float32(math.tan(fovy * 0.5)),
        )
