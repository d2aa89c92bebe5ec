"""Carry model weights across from the JAX package as plain numpy arrays.

The caller flattens a `dimo_tpu` `GaussianParams`/`GaussianAux` pair to a
dict of numpy arrays under the JAX names, e.g.

    {"xyz": ..., "features_dc": ..., "features_rest": ..., "scaling": ...,
     "rotation": ..., "opacity": ..., "c_xyz": ..., "c_radius": ..., "r": ...,
     "latent": {"codes": ...} or {"mu": ..., "log_var": ...},
     "timenet": {"trunk_0_w": (fan_in, fan_out), "trunk_0_b": ..., ...},
     "active": ..., "c_active": ..., and optionally "max_radii2d",
     "xyz_grad_accum", "denom"}

and `params_from_numpy` returns the port's objects; `lpips_params_from_numpy`
does the same for the LPIPS-VGG weights (`dimo_tpu/models/lpips.py`'s dict,
or an `.npz` with its keys). TimeNet weights are
transposed from the JAX (fan_in, fan_out) layout into nn.Linear's
(out, in). `train_state_from_numpy` also carries a JAX TrainState's Adam
moments (laid out as the parameters) and step counts across, so both
packages can continue from the same state. No JAX object crosses: the
port never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from dimo_tpu_torch.models import gaussians as G
from dimo_tpu_torch.models.lpips import _VGG_PLAN, TAP_CHANNELS
from dimo_tpu_torch.models.timenet import DEPTH, TimeNet, input_dim
from dimo_tpu_torch.train import optim
from dimo_tpu_torch.train.step import TrainState, init_state
from dimo_tpu_torch.utils.general import resolve_device

AUX_OPTIONAL = ("max_radii2d", "xyz_grad_accum", "denom")


def _t(a, dev, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(
        device=dev, dtype=dtype)


def _timenet_layers(net: TimeNet) -> dict:
    """{JAX leaf prefix: nn.Linear} of a TimeNet: the one place that maps
    the module's layers to the JAX package's leaf names."""
    layers = {f"trunk_{i}": net.trunk[i] for i in range(DEPTH)}
    layers.update(pts_0=net.pts_0, pts_1=net.pts_1, rot_0=net.rot_0,
                  rot_1=net.rot_1)
    return layers


def timenet_to_numpy(net: TimeNet) -> dict:
    """The JAX leaves of a TimeNet (inverse of `timenet_from_numpy`):
    {prefix}_w in (fan_in, fan_out), {prefix}_b."""
    out = {}
    for name, lin in _timenet_layers(net).items():
        out[f"{name}_w"] = lin.weight.detach().cpu().numpy().T.copy()
        out[f"{name}_b"] = lin.bias.detach().cpu().numpy().copy()
    return out


def timenet_from_numpy(leaves: dict, device="cuda") -> TimeNet:
    """TimeNet with the JAX leaves' weights (trunk_{i}_w/b, pts_{0,1}_w/b,
    rot_{0,1}_w/b; weights in (fan_in, fan_out))."""
    dev = resolve_device(device)
    latent_dim = int(np.asarray(leaves["trunk_0_w"]).shape[0]) - input_dim(0)
    net = TimeNet(latent_dim)
    with torch.no_grad():
        for name, lin in _timenet_layers(net).items():
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
    fields = {k: _t(d[k], dev) for k in G.PARAM_FIELDS}
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


def port_leaves_from_numpy(d: dict, device="cuda") -> dict:
    """{port leaf name (`optim.named_leaves`): tensor} of numpy leaves in
    the JAX layout (the parameter fields, "latent": {...}, "timenet":
    {"trunk_0_w": ...}); TimeNet weights are transposed to (out, in)."""
    dev = resolve_device(device)
    out = {k: _t(d[k], dev) for k in G.PARAM_FIELDS}
    out.update({f"latent.{k}": _t(v, dev) for k, v in d["latent"].items()})
    if d.get("timenet"):
        net = timenet_from_numpy(d["timenet"], dev)
        out.update({f"timenet.{k}": v.detach()
                    for k, v in net.named_parameters()})
    return out


def train_state_from_numpy(d: dict, opt: dict, step: int, device="cuda",
                           seed: int = 0) -> TrainState:
    """A port TrainState from a JAX TrainState as numpy: `d` the parameter
    and aux leaves (as for `params_from_numpy`), `opt` = {"mu": ...,
    "nu": ..., "step": int} with the Adam moments laid out as the
    parameters, `step` the stage-local step count. The state's generator
    is seeded from `seed` (JAX keys do not carry over)."""
    params, aux = params_from_numpy(d, device)
    state = init_state(params, aux, step=int(step), seed=seed)
    leaves = optim.named_leaves(params)
    mu = port_leaves_from_numpy(opt["mu"], device)
    nu = port_leaves_from_numpy(opt["nu"], device)
    for k, v in leaves.items():
        if mu[k].shape != v.shape or nu[k].shape != v.shape:
            raise ValueError(f"moment {k}: shapes {tuple(mu[k].shape)}/"
                             f"{tuple(nu[k].shape)} do not fit "
                             f"{tuple(v.shape)}")
    state.opt = optim.AdamState(
        mu={k: mu[k] for k in leaves}, nu={k: nu[k] for k in leaves},
        step=torch.tensor(int(opt["step"]), dtype=torch.int32,
                          device=params.xyz.device))
    return state


def lpips_params_from_numpy(d: dict, device="cuda") -> dict:
    """{name: float32 tensor} of LPIPS-VGG weights under the reference's
    keys (`conv{i}_w` (O, I, 3, 3), `conv{i}_b`, `lin{k}_w`), as
    `models/lpips.LPIPS` takes them."""
    dev = resolve_device(device)
    want = ([f"conv{i}_{s}" for i in range(len(_VGG_PLAN)) for s in "wb"]
            + [f"lin{k}_w" for k in range(len(TAP_CHANNELS))])
    missing = [k for k in want if k not in d]
    if missing:
        raise ValueError(f"LPIPS weights lack {missing}")
    return {k: _t(d[k], dev) for k in want}
