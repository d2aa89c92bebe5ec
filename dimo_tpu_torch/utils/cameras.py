"""Camera system: orbit poses, perspective projection, rasterizer camera.

Copy of `dimo_tpu/utils/cameras.py` (numpy only; the port keeps its own
copy and imports nothing of the JAX package). Conventions:

  * orbit poses are NeRF/OpenGL c2w matrices (camera looks down -z, y up);
  * the rasterizer camera applies the reference's axis rectification
    (flip y/z rows of w2c, negate translation) and stores matrices
    TRANSPOSED, i.e. points transform as row vectors: clip = [p, 1] @ full_proj;
  * camera_center = -c2w[:3, 3] (reference quirk, consistent with the
    rectified w2c).

`Camera` stays numpy; the rasterizer converts it to tensors on the
device of the Gaussians (`ops/rasterizer/api.py`). `OrbitCamera` (the
interactive camera; no caller yet, as in the reference) imports scipy
when it is built. The reference's `stack_cameras` builds a JAX pytree;
the port passes lists of cameras instead.
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
    def from_intrinsics(K: np.ndarray, w2c: np.ndarray, width: int, height: int,
                        znear: float = 0.01, zfar: float = 100.0) -> "Camera":
        """Build from pinhole intrinsics K (3,3) + world-to-camera (4,4)
        (the Dynamic3DGaussians-style setup_camera: w2c already in the
        rasterizer's +z-forward convention)."""
        K = np.asarray(K, np.float32)
        w2c = np.asarray(w2c, np.float32)
        fx, fy = K[0, 0], K[1, 1]
        cx, cy = K[0, 2], K[1, 2]
        fovx = 2 * np.arctan(width / (2 * fx))
        fovy = 2 * np.arctan(height / (2 * fy))
        world_view = w2c.T.astype(np.float32)
        proj = projection_matrix(znear, zfar, float(fovx), float(fovy)).T
        # principal point offset folded into the projection
        proj = proj.copy()
        proj[2, 0] += (2 * cx - width) / width
        proj[2, 1] += (2 * cy - height) / height
        full_proj = (world_view @ proj).astype(np.float32)
        campos = np.linalg.inv(w2c)[:3, 3].astype(np.float32)
        return Camera(
            world_view=world_view, full_proj=full_proj, campos=campos,
            tan_fovx=np.float32(math.tan(fovx * 0.5)),
            tan_fovy=np.float32(math.tan(fovy * 0.5)))

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


class OrbitCamera:
    """Interactive orbit camera (fov bookkeeping + orbit/scale/pan), the
    reference's `OrbitCamera`; fovy given in degrees."""

    def __init__(self, W, H, r=2, fovy=60, near=0.01, far=100):
        from scipy.spatial.transform import Rotation
        self._R = Rotation
        self.W = W
        self.H = H
        self.radius = r
        self.fovy = np.deg2rad(fovy)
        self.near = near
        self.far = far
        self.center = np.array([0, 0, 0], dtype=np.float32)
        self.rot = Rotation.from_matrix(np.eye(3))
        self.up = np.array([0, 1, 0], dtype=np.float32)

    @property
    def fovx(self):
        return 2 * np.arctan(np.tan(self.fovy / 2) * self.W / self.H)

    @property
    def campos(self):
        return self.pose[:3, 3]

    @property
    def pose(self):
        res = np.eye(4, dtype=np.float32)
        res[2, 3] = self.radius
        rot = np.eye(4, dtype=np.float32)
        rot[:3, :3] = self.rot.as_matrix()
        res = rot @ res
        res[:3, 3] -= self.center
        return res

    @property
    def view(self):
        return np.linalg.inv(self.pose)

    @property
    def perspective(self):
        y = np.tan(self.fovy / 2)
        aspect = self.W / self.H
        return np.array(
            [[1 / (y * aspect), 0, 0, 0],
             [0, -1 / y, 0, 0],
             [0, 0, -(self.far + self.near) / (self.far - self.near),
              -(2 * self.far * self.near) / (self.far - self.near)],
             [0, 0, -1, 0]], dtype=np.float32)

    @property
    def intrinsics(self):
        focal = self.H / (2 * np.tan(self.fovy / 2))
        return np.array([focal, focal, self.W // 2, self.H // 2],
                        dtype=np.float32)

    @property
    def mvp(self):
        return self.perspective @ np.linalg.inv(self.pose)

    def orbit(self, dx, dy):
        side = self.rot.as_matrix()[:3, 0]
        rotvec_x = self.up * np.radians(-0.05 * dx)
        rotvec_y = side * np.radians(-0.05 * dy)
        self.rot = (self._R.from_rotvec(rotvec_x)
                    * self._R.from_rotvec(rotvec_y) * self.rot)

    def scale(self, delta):
        self.radius *= 1.1 ** (-delta)

    def pan(self, dx, dy, dz=0):
        self.center += 0.0005 * self.rot.as_matrix()[:3, :3] @ np.array(
            [-dx, -dy, dz])
