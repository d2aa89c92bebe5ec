"""Per-Gaussian screen-space preprocessing (plain tensor ops, autograd).

Counterpart of `dimo_tpu/ops/rasterizer/projection.py`: frustum cull, EWA
projection of 3D covariances to 2D, conic and radius, SH->RGB and
camera-facing normals, in the same flat (N,) component form and op order.
The clips on the gradient path use the reference's tie conventions
(`ops/grad_conventions.py`); radius, cull radius and the frustum mask
carry no gradient, as in the reference.

Conventions (utils/cameras.py):
  * matrices are stored transposed; points transform as row vectors,
    p_view = [p, 1] @ world_view, p_clip = [p, 1] @ full_proj;
  * pixel coords: ndc2pix(v, S) = ((v + 1) * S - 1) / 2.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dimo_tpu_torch.ops import grad_conventions as gc
from dimo_tpu_torch.ops import quat as quat_ops
from dimo_tpu_torch.ops import sh as sh_ops


class Projected(NamedTuple):
    mean2d: torch.Tensor    # (N, 2) pixel coords
    depth: torch.Tensor     # (N,) view-space z
    conic: torch.Tensor     # (N, 3) inverse 2D covariance (a, b, c)
    radius: torch.Tensor    # (N,) float screen-space radius (3 sigma), 0 if culled
    in_frustum: torch.Tensor  # (N,) bool
    color: torch.Tensor     # (N, 3) RGB from SH (or override)
    normal: torch.Tensor    # (N, 3) camera-facing world normal
    cull_radius: torch.Tensor  # (N,) opacity-aware extent for binning (<= radius)


def camera_facing_normal(scales, quats, means3d, campos) -> torch.Tensor:
    """Normal = rotation column of the smallest scale axis, flipped toward
    the camera."""
    q = quat_ops.normalize(quats)
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    cols = (
        (1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy + qw * qz),
         2 * (qx * qz - qw * qy)),
        (2 * (qx * qy - qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz + qw * qx)),
        (2 * (qx * qz + qw * qy), 2 * (qy * qz - qw * qx),
         1 - 2 * (qx * qx + qy * qy)),
    )
    idx = torch.argmin(scales, dim=-1)                 # (N,) first on ties
    n = [torch.where(idx == 0, cols[0][i],
                     torch.where(idx == 1, cols[1][i], cols[2][i]))
         for i in range(3)]
    to_cam = campos[None, :] - means3d
    dot = n[0] * to_cam[:, 0] + n[1] * to_cam[:, 1] + n[2] * to_cam[:, 2]
    sign = torch.where(dot < 0.0, -1.0, 1.0)
    return torch.stack([n[0] * sign, n[1] * sign, n[2] * sign], dim=-1)


def project(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh_coeffs: torch.Tensor,
    world_view: torch.Tensor,
    full_proj: torch.Tensor,
    campos: torch.Tensor,
    tan_fovx: float,
    tan_fovy: float,
    width: int,
    height: int,
    sh_degree: int = 0,
    scale_modifier: float = 1.0,
    override_color: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
) -> Projected:
    """Project N Gaussians to screen space.

    means3d (N,3); scales (N,3) linear; quats (N,4); opacities (N,1);
    sh_coeffs (N, K, 3) with K >= (sh_degree+1)^2; camera matrices as
    tensors on the Gaussians' device; valid: optional (N,) bool mask.
    """
    n = means3d.shape[0]
    ones = torch.ones((n, 1), dtype=means3d.dtype, device=means3d.device)
    hom = torch.cat([means3d, ones], dim=-1)                 # (N, 4)

    p_view = hom @ world_view                                # (N, 4)
    tz = p_view[:, 2]
    in_front = tz > 0.2

    p_clip = hom @ full_proj                                 # (N, 4)
    p_w = 1.0 / (p_clip[:, 3] + 1e-7)
    ndc = p_clip[:, :2] * p_w[:, None]
    mean2d = torch.stack(
        [((ndc[:, 0] + 1.0) * width - 1.0) * 0.5,
         ((ndc[:, 1] + 1.0) * height - 1.0) * 0.5], dim=-1)

    # EWA: cov2d = J R cov3d R^T J^T with fov-clamped J. The camera
    # scalars are float32 in the reference; round them the same way.
    f32 = np.float32
    tan_fovx, tan_fovy = f32(tan_fovx), f32(tan_fovy)
    focal_x = float(f32(width) / (f32(2.0) * tan_fovx))
    focal_y = float(f32(height) / (f32(2.0) * tan_fovy))
    tz_safe = torch.where(in_front, tz, 1.0)
    limx = float(f32(1.3) * tan_fovx)
    limy = float(f32(1.3) * tan_fovy)
    txz = gc.clip(p_view[:, 0] / tz_safe, -limx, limx)
    tyz = gc.clip(p_view[:, 1] / tz_safe, -limy, limy)
    tx = txz * tz_safe
    ty = tyz * tz_safe

    # closed-form 2D covariance (J W M)(J W M)^T over flat (N,) components
    q = quat_ops.normalize(quats)
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    R_comp = ((r00, r01, r02), (r10, r11, r12), (r20, r21, r22))
    Rv = world_view[:3, :3].T                                # view rotation
    WR = [[sum(Rv[i, j] * R_comp[j][k] for j in range(3)) for k in range(3)]
          for i in range(3)]
    s = scales * scale_modifier
    sc = (s[:, 0], s[:, 1], s[:, 2])
    A = [[WR[i][k] * sc[k] for k in range(3)] for i in range(3)]

    # full_like(...) / t: a true division, as the reference rounds it
    # (scalar / tensor in torch multiplies by a rounded reciprocal)
    j00 = torch.full_like(tz_safe, focal_x) / tz_safe
    j02 = -(focal_x * tx) / (tz_safe * tz_safe)
    j11 = torch.full_like(tz_safe, focal_y) / tz_safe
    j12 = -(focal_y * ty) / (tz_safe * tz_safe)
    B0 = [j00 * A[0][k] + j02 * A[2][k] for k in range(3)]
    B1 = [j11 * A[1][k] + j12 * A[2][k] for k in range(3)]
    a = B0[0] * B0[0] + B0[1] * B0[1] + B0[2] * B0[2] + 0.3
    b = B0[0] * B1[0] + B0[1] * B1[1] + B0[2] * B1[2]
    c = B1[0] * B1[0] + B1[1] * B1[1] + B1[2] * B1[2] + 0.3

    det = a * c - b * b
    det_safe = torch.where(det > 0.0, det, 1.0)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], dim=-1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lam1 = mid + disc
    sigma = torch.sqrt(torch.clamp_min(lam1, 0.0))
    radius = torch.ceil(3.0 * sigma)

    # opacity-aware extent: alpha < 1/255 is zeroed by the compositor, so
    # binning out to sqrt(2 ln(op/eps)) sigma loses nothing
    alpha_eps = 1.0 / 255.0
    op = opacities[:, 0]
    tight = torch.sqrt(2.0 * torch.log(torch.clamp_min(op, alpha_eps) / alpha_eps))
    cull_radius = torch.ceil(tight * sigma)

    ok = in_front & (det > 0.0)
    if valid is not None:
        ok = ok & valid
    ok = ok & (op > alpha_eps)
    radius = torch.where(ok, radius, 0.0)
    cull_radius = torch.where(ok, cull_radius, 0.0)

    if override_color is not None:
        color = torch.broadcast_to(override_color, (n, 3))
    else:
        dirs = means3d - campos[None, :]
        dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-8)
        col = sh_ops.eval_sh(sh_degree, sh_coeffs.transpose(-1, -2), dirs)
        color = gc.maximum(col + 0.5, 0.0)

    normal = camera_facing_normal(scales, quats, means3d, campos)

    return Projected(
        mean2d=mean2d,
        depth=tz,
        conic=conic,
        radius=radius.detach(),
        in_frustum=ok.detach(),
        color=color,
        normal=normal,
        cull_radius=cull_radius.detach(),
    )
