"""Carry model weights across from the JAX package as plain numpy arrays.

The caller flattens a `dimo_tpu` `GaussianParams`/`GaussianAux` pair to a
dict of numpy arrays under the JAX names, e.g.

    {"xyz": ..., "features_dc": ..., "features_rest": ..., "scaling": ...,
     "rotation": ..., "opacity": ..., "c_xyz": ..., "c_radius": ..., "r": ...,
     "latent": {"codes": ...} or {"mu": ..., "log_var": ...},
     "timenet": {"trunk_0_w": (fan_in, fan_out), "trunk_0_b": ..., ...},
     "active": ..., "c_active": ..., and optionally "max_radii2d",
     "xyz_grad_accum", "denom"}

and `params_from_numpy` returns the port's objects. TimeNet weights are
transposed from the JAX (fan_in, fan_out) layout into nn.Linear's
(out, in). No JAX object crosses: the port never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from dimo_tpu_torch.models import gaussians as G
from dimo_tpu_torch.models.timenet import DEPTH, TimeNet, input_dim
from dimo_tpu_torch.utils.general import resolve_device

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
                "opacity", "c_xyz", "c_radius", "r")
AUX_OPTIONAL = ("max_radii2d", "xyz_grad_accum", "denom")


def _t(a, dev, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(
        device=dev, dtype=dtype)


def timenet_from_numpy(leaves: dict, device="cuda") -> TimeNet:
    """TimeNet with the JAX leaves' weights (trunk_{i}_w/b, pts_{0,1}_w/b,
    rot_{0,1}_w/b; weights in (fan_in, fan_out))."""
    dev = resolve_device(device)
    latent_dim = int(np.asarray(leaves["trunk_0_w"]).shape[0]) - input_dim(0)
    net = TimeNet(latent_dim)
    layers = {f"trunk_{i}": net.trunk[i] for i in range(DEPTH)}
    layers.update(pts_0=net.pts_0, pts_1=net.pts_1, rot_0=net.rot_0,
                  rot_1=net.rot_1)
    with torch.no_grad():
        for name, lin in layers.items():
            w = _t(leaves[f"{name}_w"], "cpu").T
            b = _t(leaves[f"{name}_b"], "cpu")
            if w.shape != lin.weight.shape or b.shape != lin.bias.shape:
                raise ValueError(f"{name}: shapes {tuple(w.shape)}/"
                                 f"{tuple(b.shape)} do not fit "
                                 f"{tuple(lin.weight.shape)}")
            lin.weight.copy_(w)
            lin.bias.copy_(b)
    return net.to(dev)


def params_from_numpy(d: dict, device="cuda"):
    """(GaussianParams, GaussianAux) from the JAX package's numpy leaves."""
    dev = resolve_device(device)
    fields = {k: _t(d[k], dev) for k in PARAM_FIELDS}
    params = G.GaussianParams(
        **fields,
        latent={k: _t(v, dev) for k, v in d["latent"].items()},
        timenet=timenet_from_numpy(d["timenet"], dev) if d.get("timenet")
        else None)
    n = fields["xyz"].shape[0]
    extra = {k: (_t(d[k], dev) if k in d else
                 torch.zeros((n,), dtype=torch.float32, device=dev))
             for k in AUX_OPTIONAL}
    aux = G.GaussianAux(active=_t(d["active"], dev, torch.bool),
                        c_active=_t(d["c_active"], dev, torch.bool), **extra)
    return params, aux
