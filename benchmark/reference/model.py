"""The model's parameters and activations, as the reference holds them.

A frozen copy of the parameter store's activations: canonical Gaussians
(`xyz`, `features_dc`, `features_rest`, log `scaling`, raw `rotation`,
logit `opacity`), control points (`c_xyz`, log `c_radius`), the shared
stage-1 log-radius `r`, the per-motion latent codes and the TimeNet. In
stage s1 the Gaussians are themselves the control points and share the
radius `r`; in s2 each has its own scale and is skinned to its nearest
control points.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .timenet import TimeNet

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "c_xyz", "c_radius", "r")


@dataclasses.dataclass
class Params:
    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    c_xyz: torch.Tensor
    c_radius: torch.Tensor
    r: torch.Tensor
    latent: dict
    timenet: Any


def from_numpy(d: dict, device) -> Params:
    """Params from the benchmark's inputs in the JAX package's layout: the
    tensor fields, "latent" {"codes"}, "timenet" {"trunk_0_w", ...} with
    weights in (fan_in, fan_out); every leaf a float32 copy on `device`
    that requires grad."""
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device,  # noqa: E731
                               requires_grad=True)
    tn = d["timenet"]
    latent_dim = d["latent"]["codes"].shape[1]
    net = TimeNet(latent_dim)
    layers = {f"trunk.{i}": f"trunk_{i}" for i in range(len(net.trunk))}
    layers.update({k: k for k in ("pts_0", "pts_1", "rot_0", "rot_1")})
    net.load_state_dict(
        {**{f"{m}.weight": torch.as_tensor(tn[f"{j}_w"]).T
            for m, j in layers.items()},
         **{f"{m}.bias": torch.as_tensor(tn[f"{j}_b"])
            for m, j in layers.items()}})
    return Params(**{f: t(d[f]) for f in PARAM_FIELDS},
                  latent={"codes": t(d["latent"]["codes"])},
                  timenet=net.to(device))


def get_scaling(p: Params, stage: str) -> torch.Tensor:
    if stage < "s2":
        return torch.exp(torch.broadcast_to(p.r[0], (p.xyz.shape[0], 3)))
    return torch.exp(p.scaling)


def get_opacity(p: Params) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_c_radius(p: Params, stage: str = "s2") -> torch.Tensor:
    if stage < "s2":
        return torch.exp(torch.broadcast_to(p.r[0], (p.xyz.shape[0], 1)))
    return torch.exp(p.c_radius)


def get_features(p: Params) -> torch.Tensor:
    return torch.cat([p.features_dc, p.features_rest], dim=1)
