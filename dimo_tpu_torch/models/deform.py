"""KNN linear-blend skinning of Gaussians by control-point motion (torch).

Counterpart of `dimo_tpu/models/deform.py`: Gaussian-kernel weights over
the 4 nearest control points, a per-neighbour local-frame rigid
transform, and the quaternion composition of the blended residual
rotations. The neighbour lookup is ONE column gather (kernel K2,
`ops/smallgather.gather_small_cols`) of the fused (11, M) table, and the
blend runs on flat (N,) component rows in the reference's op order. With
the control points' motion of R renders (d_xyz_c (R, M, 3)) the table is
(R, 11, M), gathered once a render, and the blend runs on (R, N) rows.
"""
from __future__ import annotations

import torch

from dimo_tpu_torch.ops.smallgather import gather_small_cols
from dimo_tpu_torch.utils.general import per_render

EPS = 1e-7


def knn_weights(nn_dist: torch.Tensor, c_radius_n: torch.Tensor) -> torch.Tensor:
    """w = l1-normalize(exp(-d^2 / (2 r_n^2)) + eps) over the K axis (axis
    -2; inputs are (K, N), radii also (R, K, N)); dists carry no
    gradient."""
    nn_dist = nn_dist.detach()
    # r^2 floored at 1e-8, as the reference floors it (deform.py:39): the
    # forward is unchanged and the backward avoids 0*inf as r -> 0
    r2 = torch.clamp_min(c_radius_n * c_radius_n, 1e-8)
    w = torch.exp(-(nn_dist ** 2) / (2.0 * r2)) + EPS
    return w / torch.sum(torch.abs(w), dim=-2, keepdim=True)


def _rotate_flat(qw, qx, qy, qz, vx, vy, vz):
    """Rotate (vx,vy,vz) rows by the NORMALIZED quaternion rows."""
    # norm^2 floored at 1e-6, as the reference floors it (deform.py:50)
    inv = torch.rsqrt(torch.clamp_min(
        qw * qw + qx * qx + qy * qy + qz * qz, 1e-6))
    qw, qx, qy, qz = qw * inv, qx * inv, qy * inv, qz * inv
    rx = ((1 - 2 * (qy * qy + qz * qz)) * vx
          + 2 * (qx * qy - qw * qz) * vy
          + 2 * (qx * qz + qw * qy) * vz)
    ry = (2 * (qx * qy + qw * qz) * vx
          + (1 - 2 * (qx * qx + qz * qz)) * vy
          + 2 * (qy * qz - qw * qx) * vz)
    rz = (2 * (qx * qz - qw * qy) * vx
          + 2 * (qy * qz + qw * qx) * vy
          + (1 - 2 * (qx * qx + qy * qy)) * vz)
    return rx, ry, rz


def lbs_blend(
    xyz: torch.Tensor,          # (N, 3) canonical gaussian centers
    rotation: torch.Tensor,     # (N, 4) raw (unnormalized) gaussian quats
    c_xyz: torch.Tensor,        # (M, 3) canonical control points
    d_xyz_c: torch.Tensor,      # ([R,] M, 3) control point translations at t
    d_rot_c: torch.Tensor,      # ([R,] M, 4) control point rotation residuals
    c_radius: torch.Tensor,     # (M, 1) linear radii
    nn_idx: torch.Tensor,       # (K, N) int32 neighbor cpt indices
    nn_dist: torch.Tensor,      # (K, N) neighbor euclidean distances
    local_frame: bool = True,
):
    """Returns (deformed xyz ([R,] N, 3), composed rotation ([R,] N, 4)
    normalized)."""
    k, n = nn_idx.shape
    lead = d_xyz_c.shape[:-2]
    m = c_xyz.shape[0]
    # ONE fused neighbour lookup a render, column layout: rows are
    # components [radius | c_xyz(3) | d_xyz(3) | d_rot(4)], columns are
    # (K*N) sites
    table_t = torch.cat([c_radius.T.expand(*lead, 1, m),
                         c_xyz.T.expand(*lead, 3, m),
                         d_xyz_c.transpose(-1, -2), d_rot_c.transpose(-1, -2)],
                        dim=-2).contiguous()                    # (..., 11, M)
    if lead:
        g = per_render(lambda i: gather_small_cols(table_t[i], nn_idx),
                       lead[0])                                 # (R, 11, K, N)
    else:
        g = gather_small_cols(table_t, nn_idx)                  # (11, K, N)
    w = knn_weights(nn_dist, g[..., 0, :, :])                   # (..., K, N)

    x0, x1, x2 = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    px = torch.zeros_like(x0)
    py = torch.zeros_like(x0)
    pz = torch.zeros_like(x0)
    rw = torch.zeros_like(x0)
    rx = torch.zeros_like(x0)
    ry = torch.zeros_like(x0)
    rz = torch.zeros_like(x0)
    for j in range(k):
        wk = w[..., j, :]
        cx, cy, cz = (g[..., c, j, :] for c in (1, 2, 3))
        dx, dy, dz = (g[..., c, j, :] for c in (4, 5, 6))
        qw, qx, qy, qz = (g[..., c, j, :] for c in (7, 8, 9, 10))
        if local_frame:
            mx, my, mz = _rotate_flat(qw, qx, qy, qz,
                                      x0 - cx, x1 - cy, x2 - cz)
            px = px + wk * (mx + cx + dx)
            py = py + wk * (my + cy + dy)
            pz = pz + wk * (mz + cz + dz)
        else:
            px = px + wk * dx
            py = py + wk * dy
            pz = pz + wk * dz
        # blended residual rotation uses the RAW (unnormalized) quats
        rw = rw + wk * qw
        rx = rx + wk * qx
        ry = ry + wk * qy
        rz = rz + wk * qz
    if not local_frame:
        px, py, pz = x0 + px, x1 + py, x2 + pz

    # compose with the gaussian's own quaternion: (blended) * rotation
    bw, bx, by, bz = (rotation[:, 0], rotation[:, 1],
                      rotation[:, 2], rotation[:, 3])
    ow = rw * bw - rx * bx - ry * by - rz * bz
    ox = rw * bx + rx * bw + ry * bz - rz * by
    oy = rw * by - rx * bz + ry * bw + rz * bx
    oz = rw * bz + rx * by - ry * bx + rz * bw
    # norm^2 floored at 1e-6, as the reference floors it (deform.py:131)
    inv = torch.rsqrt(torch.clamp_min(
        ow * ow + ox * ox + oy * oy + oz * oz, 1e-6))
    rot = torch.stack([ow * inv, ox * inv, oy * inv, oz * inv], dim=-1)
    pts = torch.stack([px, py, pz], dim=-1)
    return pts, rot
