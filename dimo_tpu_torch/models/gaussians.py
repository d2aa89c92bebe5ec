"""Canonical 3D Gaussians + control points + latent motion space (torch).

Counterpart of the parameter store and activations of
`dimo_tpu/models/gaussians.py`. Learnable state lives in `GaussianParams`
(tensors, the latent dict and the `TimeNet` module), bookkeeping in
`GaussianAux`. Arrays are allocated at a fixed capacity with an `active`
mask, as in the reference, so the two packages index the same slots.

Stage semantics:
  * s1: the Gaussians ARE the control points; all share one learnable
    log-radius `r`;
  * s2: per-Gaussian `scaling`; control points `c_xyz` with per-point
    log-radius `c_radius`; deformation via KNN linear-blend skinning.

The densify / prune mutations (`dimo_tpu/models/gaussians.py:274-467`)
come with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from dimo_tpu_torch.models.timenet import TimeNet
from dimo_tpu_torch.ops import neighbors, sh as sh_ops
from dimo_tpu_torch.utils.general import inverse_sigmoid, resolve_device


@dataclasses.dataclass
class GaussianParams:
    xyz: torch.Tensor            # (Nmax, 3)
    features_dc: torch.Tensor    # (Nmax, 1, 3)
    features_rest: torch.Tensor  # (Nmax, K-1, 3) (K=(deg+1)^2)
    scaling: torch.Tensor        # (Nmax, 3) log-scale
    rotation: torch.Tensor       # (Nmax, 4)
    opacity: torch.Tensor        # (Nmax, 1) logit
    c_xyz: torch.Tensor          # (M, 3) control points
    c_radius: torch.Tensor       # (M, 1) log-radius
    r: torch.Tensor              # (1, 1) shared log-radius (s1)
    latent: dict                 # {"codes": (V, L)} or {"mu","log_var": (V, L)}
    timenet: Any                 # TimeNet module (None until set)

    def replace(self, **kw) -> "GaussianParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class GaussianAux:
    active: torch.Tensor          # (Nmax,) bool
    c_active: torch.Tensor        # (M,) bool
    max_radii2d: torch.Tensor     # (Nmax,)
    xyz_grad_accum: torch.Tensor  # (Nmax,)
    denom: torch.Tensor           # (Nmax,)

    def replace(self, **kw) -> "GaussianAux":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    sh_degree: int = 0
    latent_dim: int = 32
    num_latents: int = 1
    vae: bool = False
    capacity: int = 8192         # Gaussian slot capacity (multiple of 8)
    cpt_capacity: int = 512      # control point capacity
    percent_dense: float = 0.01

    @property
    def sh_coeffs(self) -> int:
        return (self.sh_degree + 1) ** 2


# ---------------------------------------------------------------------------
# activations

def get_scaling(p: GaussianParams, stage: str) -> torch.Tensor:
    """Linear scales (Nmax, 3); s1 broadcasts the shared radius."""
    if stage < "s2":
        return torch.exp(torch.broadcast_to(p.r[0], (p.xyz.shape[0], 3)))
    return torch.exp(p.scaling)


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_c_radius(p: GaussianParams, stage: str = "s2") -> torch.Tensor:
    if stage < "s2":
        return torch.exp(torch.broadcast_to(p.r[0], (p.xyz.shape[0], 1)))
    return torch.exp(p.c_radius)


def get_features(p: GaussianParams) -> torch.Tensor:
    """(Nmax, K, 3) full SH coefficient stack."""
    return torch.cat([p.features_dc, p.features_rest], dim=1)


def sample_latent(p: GaussianParams, index: int,
                  rng: torch.Generator | None = None) -> torch.Tensor:
    """Latent code for one motion; the VAE variant reparameterizes with
    noise from `rng` when one is given (the mean otherwise). Row `index`
    is read directly: the reference's one-hot matmul selects the same row
    exactly."""
    if "codes" in p.latent:
        return p.latent["codes"][index]
    mu = p.latent["mu"][index]
    if rng is None:
        return mu
    std = torch.exp(0.5 * p.latent["log_var"][index])
    noise = torch.randn(mu.shape, generator=rng, dtype=mu.dtype,
                        device=rng.device).to(mu.device)
    return mu + std * noise


# ---------------------------------------------------------------------------
# initialization

def _random_ball(rng: np.random.RandomState, n: int, radius: float) -> np.ndarray:
    """Uniform-in-ball sampling, the reference initializer's distribution."""
    phis = rng.random(n) * 2 * np.pi
    costheta = rng.random(n) * 2 - 1
    thetas = np.arccos(costheta)
    mu = rng.random(n)
    rr = radius * np.cbrt(mu)
    x = rr * np.sin(thetas) * np.cos(phis)
    y = rr * np.sin(thetas) * np.sin(phis)
    z = rr * np.cos(thetas)
    return np.stack([x, y, z], axis=1).astype(np.float32)


def _blank(cfg: ModelConfig, device="cuda") -> tuple[GaussianParams, GaussianAux]:
    dev = resolve_device(device)
    n, m, k = cfg.capacity, cfg.cpt_capacity, cfg.sh_coeffs
    f32 = dict(dtype=torch.float32, device=dev)
    rotation = torch.zeros((n, 4), **f32)
    rotation[:, 0] = 1.0
    params = GaussianParams(
        xyz=torch.zeros((n, 3), **f32),
        features_dc=torch.zeros((n, 1, 3), **f32),
        features_rest=torch.zeros((n, max(k - 1, 0), 3), **f32),
        scaling=torch.full((n, 3), -10.0, **f32),
        rotation=rotation,
        opacity=torch.full((n, 1), -10.0, **f32),
        c_xyz=torch.zeros((m, 3), **f32),
        c_radius=torch.full((m, 1), -5.0, **f32),
        r=torch.zeros((1, 1), **f32),
        latent={},
        timenet=None,
    )
    aux = GaussianAux(
        active=torch.zeros((n,), dtype=torch.bool, device=dev),
        c_active=torch.zeros((m,), dtype=torch.bool, device=dev),
        max_radii2d=torch.zeros((n,), **f32),
        xyz_grad_accum=torch.zeros((n,), **f32),
        denom=torch.zeros((n,), **f32),
    )
    return params, aux


def set_points_from_cloud(cfg: ModelConfig, params: GaussianParams,
                          aux: GaussianAux, pts: np.ndarray,
                          colors: np.ndarray) -> tuple[GaussianParams, GaussianAux]:
    """Fill Gaussian slots from a point cloud (create_from_pcd semantics:
    log-scale from sqrt(mean 3-NN sq dist), identity quats, opacity 0.05)."""
    n_new = pts.shape[0]
    cap = cfg.capacity
    assert n_new <= cap, (n_new, cap)
    dev = params.xyz.device
    pts_t = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(dev)
    d2 = neighbors.mean_sq_dist_3nn(pts_t)
    scales = torch.log(torch.sqrt(torch.clamp_min(d2, 1e-7)))[:, None].repeat(1, 3)

    def fill(base, new_rows):
        out = base.clone()
        out[:n_new] = torch.as_tensor(new_rows, dtype=out.dtype, device=dev)
        return out

    fdc = sh_ops.rgb_to_sh(colors)[:, None, :]
    op0 = float(inverse_sigmoid(torch.tensor(0.05)))
    params = params.replace(
        xyz=fill(params.xyz, pts_t),
        features_dc=fill(params.features_dc, fdc),
        features_rest=torch.zeros_like(params.features_rest),
        scaling=fill(params.scaling, scales),
        rotation=fill(params.rotation,
                      np.tile(np.array([1, 0, 0, 0], np.float32), (n_new, 1))),
        opacity=fill(params.opacity, np.full((n_new, 1), op0, np.float32)),
    )
    active = torch.zeros((cap,), dtype=torch.bool, device=dev)
    active[:n_new] = True
    aux = aux.replace(
        active=active,
        max_radii2d=torch.zeros((cap,), device=dev),
        xyz_grad_accum=torch.zeros((cap,), device=dev),
        denom=torch.zeros((cap,), device=dev),
    )
    return params, aux


def init_model(cfg: ModelConfig, seed: int = 0, num_pts: int = 512,
               num_cpts: int = 512, radius: float = 0.5,
               radius2: float = 0.5,
               device="cuda") -> tuple[GaussianParams, GaussianAux]:
    """Random-blob initialization (reference Renderer.initialize +
    create_from_pcd). Points come from numpy's RandomState(seed) as in the
    JAX package; latents and TimeNet from torch.Generator(seed)."""
    rng = np.random.RandomState(seed)
    pts = _random_ball(rng, num_pts, radius)
    colors = sh_ops.sh_to_rgb(rng.random((num_pts, 3)).astype(np.float32) / 255.0)
    cpts = _random_ball(rng, num_cpts, radius2)

    params, aux = _blank(cfg, device)
    params, aux = set_points_from_cloud(cfg, params, aux, pts, colors)
    dev = params.xyz.device

    m = cfg.cpt_capacity
    c_xyz = np.zeros((m, 3), np.float32)
    c_xyz[:num_cpts] = cpts[:m]
    c_active = np.zeros((m,), bool)
    c_active[:num_cpts] = True

    # shared + per-cpt radii start from the gaussian scale statistics
    scaling_np = params.scaling.cpu().numpy()
    active_np = aux.active.cpu().numpy()
    mean_log_scale = float(scaling_np[active_np, 0].mean())
    c_radius = np.full((m, 1), mean_log_scale, np.float32)
    c_radius[:num_cpts] = scaling_np[:num_cpts, :1]

    gen = torch.Generator().manual_seed(seed)
    shape = (cfg.num_latents, cfg.latent_dim)
    if cfg.vae:
        latent = {"mu": torch.randn(shape, generator=gen).to(dev),
                  "log_var": torch.zeros(shape, device=dev)}
    else:
        latent = {"codes": torch.randn(shape, generator=gen).to(dev)}
    params = params.replace(
        c_xyz=torch.from_numpy(c_xyz).to(dev),
        c_radius=torch.from_numpy(c_radius).to(dev),
        r=torch.full((1, 1), mean_log_scale, dtype=torch.float32, device=dev),
        latent=latent,
        timenet=TimeNet(cfg.latent_dim, generator=gen).to(dev),
    )
    aux = aux.replace(c_active=torch.from_numpy(c_active).to(dev))
    return params, aux
