"""As-rigid-as-possible regularisation over deformed control-point graphs.

Counterpart of `dimo_tpu/ops/arap.py`:
  * `connectivity_shared`: edges within `radius` in every sampled frame
    (dense small-N path), nearest first by frame-0 distance;
  * `connectivity_sampled`: the same for a subset `sel` of source nodes,
    testing only the `candidates` nearest frame-0 neighbours;
  * `_procrustes`: per-node best-fit rotation by Horn's quaternion method
    (top eigenvector of a 4x4 by 30 shifted power iterations), with no
    gradient, as the reference computes it under stop_gradient;
  * `arap_error` / `arap_loss`: sum over frames and edges of
    w * |e_t - R e_0|^2.

Edges are fixed-shape (rows, k) index + mask tensors. Where fewer than k
neighbours qualify, the padded picks are masked out, so which index
`torch.topk` puts there does not matter.
"""
from __future__ import annotations

import torch

from dimo_tpu_torch.ops import quat as quat_ops
from dimo_tpu_torch.ops.neighbors import pairwise_sq_dists


def connectivity_shared(points_t: torch.Tensor, k: int = 10,
                        radius: float = 0.1,
                        valid: torch.Tensor | None = None):
    """points_t (T, N, 3) -> idx (N, k) int64, mask (N, k) bool: neighbours
    within `radius` in every frame, nearest first at frame 0."""
    t, n, _ = points_t.shape
    d2 = torch.stack([pairwise_sq_dists(p, p) for p in points_t])  # (T, N, N)
    inside = torch.all(d2 < radius * radius, dim=0)
    inside = inside & ~torch.eye(n, dtype=torch.bool, device=points_t.device)
    if valid is not None:
        inside = inside & valid[:, None] & valid[None, :]
    score = torch.where(inside, d2[0], torch.inf)
    vals, idx = torch.topk(score, k, dim=1, largest=False)
    return idx, torch.isfinite(vals)


def connectivity_sampled(points_t: torch.Tensor, sel: torch.Tensor,
                         k: int = 10, radius: float = 0.1,
                         valid: torch.Tensor | None = None,
                         candidates: int = 24):
    """Shared-edge connectivity of the source rows `sel` (S,) only, over
    their `candidates` nearest frame-0 neighbours. Returns idx (S, k) rows
    into N and mask (S, k)."""
    t, n, _ = points_t.shape
    kc = min(candidates, n)
    p0 = points_t[0]
    d2_0 = pairwise_sq_dists(p0[sel], p0)                        # (S, N)
    col = torch.arange(n, device=points_t.device)[None, :]
    bad = col == sel[:, None]
    if valid is not None:
        bad = bad | ~valid[None, :]
    score0 = torch.where(bad, torch.inf, d2_0)
    cand_d0, cand = torch.topk(score0, kc, dim=1, largest=False)  # (S, Kc)
    src_t = points_t[:, sel]                                      # (T, S, 3)
    cand_t = points_t[:, cand.reshape(-1)].reshape(t, *cand.shape, 3)
    d2_t = torch.sum((src_t[:, :, None, :] - cand_t) ** 2, dim=-1)
    inside_all = torch.all(d2_t < radius * radius, dim=0)
    inside_all = inside_all & torch.isfinite(cand_d0)
    score = torch.where(inside_all, cand_d0, torch.inf)
    vals, pick = torch.topk(score, k, dim=1, largest=False)
    return torch.gather(cand, 1, pick), torch.isfinite(vals)


@torch.no_grad()
def _procrustes(e0: torch.Tensor, et: torch.Tensor, w: torch.Tensor,
                iters: int = 30) -> torch.Tensor:
    """Per-row rotation R (..., 3, 3) minimising sum_k w |et - R e0|^2.
    e0, et (..., K, 3); w (..., K). det(R) = +1 by construction, and an
    undeformed row (S = 0) gives the identity."""
    S = torch.einsum("...ki,...k,...kj->...ij", e0, w, et)
    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    row0 = torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1)
    row1 = torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1)
    row2 = torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1)
    row3 = torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1)
    nmat = torch.stack([row0, row1, row2, row3], dim=-2)          # (..., 4, 4)
    # shift so the top eigenvalue is dominant and positive
    shift = 2.0 * torch.sqrt(torch.sum(S * S, dim=(-2, -1)))[..., None, None] + 1e-6
    m = nmat + shift * torch.eye(4, dtype=S.dtype, device=S.device)
    q = torch.zeros(S.shape[:-2] + (4,), dtype=S.dtype, device=S.device)
    q[..., 0] = 1.0
    for _ in range(iters):
        q = torch.einsum("...ij,...j->...i", m, q)
        q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-20)
    return quat_ops.to_matrix(q)


def arap_error(points_t: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
               weight: torch.Tensor | None = None,
               sel: torch.Tensor | None = None) -> torch.Tensor:
    """ARAP energy of a trajectory (T, N, 3) against frame 0. sel: optional
    (S,) source rows matching idx/mask rows; None = rows are the nodes."""
    w = mask.to(points_t.dtype) if weight is None else weight
    src = points_t if sel is None else points_t[:, sel]
    e = src[:, :, None, :] - points_t[:, idx]                # (T, R, K, 3)
    e = torch.where(mask[None, ..., None], e, torch.zeros_like(e))
    e0, et = e[0], e[1:]
    R = _procrustes(e0.expand_as(et), et, w.expand(et.shape[:-1]))
    rigid = torch.einsum("tnij,nkj->tnki", R, e0)
    stretch = et - rigid
    return torch.sum(w * torch.sum(stretch * stretch, dim=-1))


def arap_loss(base_pts: torch.Tensor, d_xyz_t: torch.Tensor,
              valid: torch.Tensor | None = None, k: int = 10,
              radius: float = 0.1, sample_num: int = 512,
              generator: torch.Generator | None = None,
              sel: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's arap_loss_v2: trajectory = detached base + d_xyz_t
    (T, N, 3); shared-edge graph; energy against frame 0. When N exceeds
    `sample_num` the energy is taken over `sample_num` source nodes drawn
    with replacement (uniform over the valid nodes) from `generator`, or
    over the given `sel`."""
    pts_t = base_pts.detach()[None] + d_xyz_t
    pts_ng = pts_t.detach()
    n = base_pts.shape[0]
    if n <= sample_num and sel is None:
        idx, mask = connectivity_shared(pts_ng, k=k, radius=radius, valid=valid)
        return arap_error(pts_t, idx, mask)
    if sel is None:
        if generator is None:
            raise ValueError("arap_loss: a generator or sel is required when "
                             "N > sample_num")
        p = (valid.float() if valid is not None
             else torch.ones(n, device=base_pts.device))
        sel = torch.multinomial(p.cpu(), sample_num, replacement=True,
                                generator=generator).to(base_pts.device)
    idx, mask = connectivity_sampled(pts_ng, sel, k=k, radius=radius,
                                     valid=valid)
    return arap_error(pts_t, idx, mask, sel=sel)
