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

The train step (`train/step.py`) trains these leaves in place, and so do
the densify / prune / FPS mutations below: they write rows of the
existing leaves (and of the Adam moments, dicts keyed by leaf name as
`train/optim.py::named_leaves` names them) under `torch.no_grad()`, so
the optimizer keeps addressing the same tensors. Clone and split write
into free slots, prune clears mask bits; the slot a new Gaussian lands in
is the reference's (the r-th selected row goes to the r-th free slot, and
rows beyond the free slots are dropped).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from dimo_tpu_torch.models.timenet import TimeNet
from dimo_tpu_torch.ops import neighbors, quat as quat_ops, sh as sh_ops
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


# the tensor fields of GaussianParams (the learnable leaves besides the
# latent dict and TimeNet), under the same names in both packages
PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "c_xyz", "c_radius", "r")


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


def initialize_ag(cfg: ModelConfig, params: GaussianParams, aux: GaussianAux,
                  seed: int, num_pts_per_cpt: int = 200,
                  init_ratio: float = 1.0) -> tuple[GaussianParams, GaussianAux]:
    """Adaptive-Gaussian init for stage 2: `num_pts_per_cpt` Gaussians in a
    ball of radius mean(c_radius) * init_ratio around every active control
    point, drawn from numpy's RandomState(seed) as the reference draws
    them."""
    rng = np.random.RandomState(seed)
    c_act = aux.c_active.cpu().numpy()
    c_rad = np.exp(params.c_radius.detach().cpu().numpy())[c_act]
    centers = params.c_xyz.detach().cpu().numpy()[c_act]
    num_cpts = centers.shape[0]

    ball = _random_ball(rng, num_pts_per_cpt, float(c_rad.mean()) * init_ratio)
    pts = (centers[:, None, :] + ball[None, :, :]).reshape(-1, 3)
    colors = sh_ops.sh_to_rgb(
        rng.random((num_cpts * num_pts_per_cpt, 3)).astype(np.float32) / 255.0)
    return set_points_from_cloud(cfg, params, aux, pts, colors)


# ---------------------------------------------------------------------------
# densification / pruning (in place, under no_grad)

_PER_GAUSSIAN = ("xyz", "features_dc", "features_rest", "scaling",
                 "rotation", "opacity")


def _free_slot_of_rank(active: torch.Tensor) -> torch.Tensor:
    """Map rank r -> index of the (r+1)-th inactive slot; `capacity` for
    ranks beyond the free slots. (capacity,) int64."""
    cap = active.shape[0]
    free = torch.nonzero(~active)[:, 0]
    slot_of_rank = torch.full((cap,), cap, dtype=torch.int64,
                              device=active.device)
    slot_of_rank[:free.shape[0]] = free
    return slot_of_rank


def _dest_of_selected(active: torch.Tensor, sel: torch.Tensor):
    """(dest, ok): row i of the selection goes to free slot dest[i] where
    ok[i]; selected rows beyond the free slots are dropped."""
    cap = active.shape[0]
    slot_of_rank = _free_slot_of_rank(active)
    rank = torch.cumsum(sel.to(torch.int64), 0) - 1
    dest = slot_of_rank[rank.clamp(0, cap - 1)]
    return dest, sel & (dest < cap)


@torch.no_grad()
def _scatter_rows(params: GaussianParams, dest: torch.Tensor, new_vals: dict,
                  ok: torch.Tensor) -> GaussianParams:
    """Write new_vals[name][i] into row dest[i] of leaf `name` where ok."""
    rows = dest[ok]
    for name, val in new_vals.items():
        getattr(params, name)[rows] = val[ok]
    return params


@torch.no_grad()
def _zero_moment_rows(moments: tuple, dest: torch.Tensor, ok: torch.Tensor):
    """Zero the Adam moments of the per-Gaussian leaves at rows dest[ok]."""
    rows = dest[ok]
    for m in moments:
        for name in _PER_GAUSSIAN:
            m[name][rows] = 0.0
    return moments


@torch.no_grad()
def add_densification_stats(aux: GaussianAux, mean2d_grad: torch.Tensor,
                            visibility: torch.Tensor) -> GaussianAux:
    """Accumulate ||dL/dmeans2D|| for visible gaussians."""
    norm = torch.linalg.norm(mean2d_grad[:, :2], dim=-1)
    return aux.replace(
        xyz_grad_accum=aux.xyz_grad_accum
        + torch.where(visibility, norm, torch.zeros_like(norm)),
        denom=aux.denom + visibility.to(aux.denom.dtype))


@torch.no_grad()
def update_max_radii(aux: GaussianAux, radii: torch.Tensor,
                     visibility: torch.Tensor) -> GaussianAux:
    return aux.replace(max_radii2d=torch.where(
        visibility, torch.maximum(aux.max_radii2d, radii), aux.max_radii2d))


@torch.no_grad()
def densify_and_prune(cfg: ModelConfig, params: GaussianParams,
                      aux: GaussianAux, moments: tuple, stage: str,
                      max_grad: float, min_opacity: float, extent: float,
                      max_screen_size: float | None,
                      generator: torch.Generator | None = None, noise=None):
    """Clone + split + prune. moments: (mu, nu) Adam moment dicts; rows
    that receive a new Gaussian get zero moments. The split's noise comes
    from `generator`, or is given as `noise` (n_split, capacity, 3).
    Returns (params, aux, moments); the screen-size prune is inert, as in
    the reference (its max_radii2D is zeroed just before it is read)."""
    grads = torch.nan_to_num(aux.xyz_grad_accum
                             / torch.clamp_min(aux.denom, 1.0))
    max_scale = torch.amax(get_scaling(params, stage), dim=1)
    dense_lim = cfg.percent_dense * extent

    clone_sel = (grads >= max_grad) & (max_scale <= dense_lim) & aux.active
    params, aux, moments = _clone(params, aux, moments, clone_sel)

    split_sel = (grads >= max_grad) & (max_scale > dense_lim) & aux.active
    params, aux, moments = _split(params, aux, moments, split_sel, stage,
                                  generator=generator, noise=noise)

    prune_mask = get_opacity(params)[:, 0] < min_opacity
    if max_screen_size:
        prune_mask = prune_mask | (
            torch.amax(get_scaling(params, stage), dim=1) > 0.1 * extent)
    params, aux = prune(params, aux, prune_mask)

    aux = aux.replace(
        xyz_grad_accum=torch.zeros_like(aux.xyz_grad_accum),
        denom=torch.zeros_like(aux.denom),
        max_radii2d=torch.zeros_like(aux.max_radii2d))
    return params, aux, moments


@torch.no_grad()
def _clone(params, aux, moments, sel):
    dest, ok = _dest_of_selected(aux.active, sel)
    new_vals = {name: getattr(params, name) for name in _PER_GAUSSIAN}
    params = _scatter_rows(params, dest, new_vals, ok)
    active = aux.active.clone()
    active[dest[ok]] = True
    moments = _zero_moment_rows(moments, dest, ok)
    return params, aux.replace(active=active), moments


@torch.no_grad()
def _split(params, aux, moments, sel, stage, n_split: int = 2,
           generator: torch.Generator | None = None, noise=None):
    """Replace each selected Gaussian by `n_split` smaller ones sampled
    inside it. noise: (n_split, capacity, 3) standard normal draws (the
    tests pass the reference's); drawn from `generator` otherwise."""
    scaling = get_scaling(params, stage)
    R = quat_ops.to_matrix(params.rotation)
    if noise is None:
        if generator is None:
            raise ValueError("_split: a generator or noise is required")
        noise = torch.randn((n_split,) + tuple(params.xyz.shape),
                            generator=generator,
                            device=generator.device).to(params.xyz.device)
    # rows are read at the selected slots and written to free ones, so the
    # leaves can be read while they are being filled
    src = {name: getattr(params, name) for name in _PER_GAUSSIAN}
    active = aux.active.clone()
    for s in range(n_split):
        dest, ok = _dest_of_selected(active, sel)
        new_xyz = torch.einsum("nij,nj->ni", R, noise[s] * scaling) + params.xyz
        vals = dict(src, xyz=new_xyz,
                    scaling=torch.log(scaling / (0.8 * n_split)))
        params = _scatter_rows(params, dest, vals, ok)
        active[dest[ok]] = True
        moments = _zero_moment_rows(moments, dest, ok)
    # the split originals are pruned
    return params, aux.replace(active=active & ~sel), moments


def prune(params: GaussianParams, aux: GaussianAux, prune_mask: torch.Tensor):
    """Deactivate gaussians where prune_mask."""
    return params, aux.replace(active=aux.active & ~prune_mask)


@torch.no_grad()
def prune_only(cfg: ModelConfig, params, aux, stage: str, min_opacity: float,
               extent: float, max_screen_size: float | None):
    """The stage-2 periodic prune: by opacity and world size (the
    screen-size criterion is inert in the reference there too)."""
    mask = get_opacity(params)[:, 0] < min_opacity
    if max_screen_size:
        mask = mask | (torch.amax(get_scaling(params, stage), dim=1)
                       > 0.1 * extent)
    return prune(params, aux, mask & aux.active)


@torch.no_grad()
def reset_opacity(params: GaussianParams, moments: tuple):
    """Clamp opacity to <= 0.01 and zero its Adam moments."""
    cap = torch.minimum(get_opacity(params),
                        params.opacity.new_tensor(0.01))
    params.opacity.copy_(inverse_sigmoid(cap))
    for m in moments:
        m["opacity"].zero_()
    return params, moments


@torch.no_grad()
def fps_anneal(params: GaussianParams, aux: GaussianAux, num_pts: int):
    """Keep `num_pts` farthest-point-sampled active gaussians (s1 anneal)."""
    idx = neighbors.farthest_point_sampling(params.xyz, num_pts, aux.active)
    keep = torch.zeros_like(aux.active)
    keep[idx.long()] = True
    return params, aux.replace(active=keep & aux.active)


def num_active(aux: GaussianAux) -> torch.Tensor:
    return torch.sum(aux.active.to(torch.int32))
