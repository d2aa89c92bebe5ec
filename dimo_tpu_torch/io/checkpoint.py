"""Checkpointing: npz files + the reference's torch .pth twins.

Counterpart of `dimo_tpu/io/checkpoint.py`, with the same files and key
names, so a stage directory written by either package loads in the other:

  * `timenet[_step].npz`: the TimeNet under the JAX package's leaf names
    (`trunk_{j}_w` in (fan_in, fan_out), `trunk_{j}_b`, `pts_*`, `rot_*`);
  * `latent_codes[_step].npz`: {"codes"} or {"mu", "log_var"};
  * `timenet[_step].pth`: the reference's state dict (`deformnet.{j}`,
    `pts_layers.{0,2}`, `rot_layers.{0,2}`, weights (out, in)), and
    `latent_codes.pth` or `mu.pth` + `log_var.pth`.

The port's `TimeNet` module reaches those names through
`io/convert.py::timenet_to_numpy` / `timenet_from_numpy`, the one place
that knows the module's layers.

`save_train_state` / `load_train_state` write a full `TrainState`
(parameters, bookkeeping, Adam moments, step counts, generator state) as
one npz of named leaves. It is the port's own layout; a JAX TrainState is
read by `io/convert.py::train_state_from_numpy`.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from dimo_tpu_torch.io.convert import timenet_from_numpy, timenet_to_numpy
from dimo_tpu_torch.models import gaussians as G
from dimo_tpu_torch.models.timenet import DEPTH, TimeNet, input_dim
from dimo_tpu_torch.train import optim
from dimo_tpu_torch.train.step import TrainState
from dimo_tpu_torch.utils.general import resolve_device

_HEADS = (("pts", "pts_layers"), ("rot", "rot_layers"))
_HEAD_LAYERS = ((0, 0), (1, 2))
_AUX_FIELDS = ("active", "c_active", "max_radii2d", "xyz_grad_accum", "denom")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# npz

def save_npz(path: str, tree: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{k: _np(v) for k, v in tree.items()})


def load_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# TimeNet leaves (JAX names) <-> the reference's torch state dict

def timenet_to_torch_state(leaves: dict) -> dict:
    sd = {}
    for j in range(DEPTH):
        sd[f"deformnet.{j}.weight"] = torch.from_numpy(
            _np(leaves[f"trunk_{j}_w"]).T.copy())
        sd[f"deformnet.{j}.bias"] = torch.from_numpy(
            _np(leaves[f"trunk_{j}_b"]).copy())
    for ours, theirs in _HEADS:
        for li, tj in _HEAD_LAYERS:
            sd[f"{theirs}.{tj}.weight"] = torch.from_numpy(
                _np(leaves[f"{ours}_{li}_w"]).T.copy())
            sd[f"{theirs}.{tj}.bias"] = torch.from_numpy(
                _np(leaves[f"{ours}_{li}_b"]).copy())
    return sd


def timenet_from_torch_state(sd: dict) -> dict:
    leaves = {}
    for j in range(DEPTH):
        leaves[f"trunk_{j}_w"] = _np(sd[f"deformnet.{j}.weight"]).astype(
            np.float32).T
        leaves[f"trunk_{j}_b"] = _np(sd[f"deformnet.{j}.bias"]).astype(
            np.float32)
    for ours, theirs in _HEADS:
        for li, tj in _HEAD_LAYERS:
            leaves[f"{ours}_{li}_w"] = _np(sd[f"{theirs}.{tj}.weight"]).astype(
                np.float32).T
            leaves[f"{ours}_{li}_b"] = _np(sd[f"{theirs}.{tj}.bias"]).astype(
                np.float32)
    return leaves


# ---------------------------------------------------------------------------
# model save/load (the reference's directory layout)

def save_model(path: str, latent: dict, timenet: TimeNet, step=None) -> None:
    """<path>/timenet[_step].npz + latent_codes[_step].npz and their .pth
    twins (timenet, and latent_codes or mu + log_var)."""
    os.makedirs(path, exist_ok=True)
    suffix = f"_{step}" if step else ""
    leaves = timenet_to_numpy(timenet)
    lat = {k: _np(v) for k, v in latent.items()}
    save_npz(os.path.join(path, f"timenet{suffix}.npz"), leaves)
    save_npz(os.path.join(path, f"latent_codes{suffix}.npz"), lat)
    torch.save(timenet_to_torch_state(leaves),
               os.path.join(path, f"timenet{suffix}.pth"))
    names = {"codes": "latent_codes", "mu": "mu", "log_var": "log_var"}
    for k, v in lat.items():
        torch.save(torch.from_numpy(v.copy()),
                   os.path.join(path, f"{names[k]}{suffix}.pth"))


def load_model(path: str, step=None, vae: bool = False,
               device="cuda") -> tuple[dict, TimeNet]:
    """(latent dict of tensors, TimeNet) from the npz files if present,
    else from the .pth files."""
    dev = resolve_device(device)
    suffix = f"_{step}" if step else ""
    npz_t = os.path.join(path, f"timenet{suffix}.npz")
    npz_l = os.path.join(path, f"latent_codes{suffix}.npz")
    if os.path.exists(npz_t) and os.path.exists(npz_l):
        leaves, lat = load_npz(npz_t), load_npz(npz_l)
    else:
        def pth(name):
            return torch.load(os.path.join(path, f"{name}{suffix}.pth"),
                              map_location="cpu", weights_only=True)
        leaves = timenet_from_torch_state(pth("timenet"))
        lat = ({"mu": _np(pth("mu")), "log_var": _np(pth("log_var"))} if vae
               else {"codes": _np(pth("latent_codes"))})
    latent = {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
              for k, v in lat.items()}
    return latent, timenet_from_numpy(leaves, dev)


# ---------------------------------------------------------------------------
# full training-state snapshots (incl. Adam moments)

def save_train_state(path: str, state: TrainState) -> None:
    """One npz of named leaves: `params.<leaf>`, `mu.<leaf>`, `nu.<leaf>`
    (leaf names of `optim.named_leaves`), `aux.<field>`, `opt_step`,
    `step` and the generator's state."""
    arrays = {}
    for k, v in optim.named_leaves(state.params).items():
        arrays[f"params.{k}"] = v
        arrays[f"mu.{k}"] = state.opt.mu[k]
        arrays[f"nu.{k}"] = state.opt.nu[k]
    for f in _AUX_FIELDS:
        arrays[f"aux.{f}"] = getattr(state.aux, f)
    arrays["opt_step"] = state.opt.step
    arrays["step"] = np.asarray(state.step, np.int64)
    arrays["rng_state"] = state.rng.get_state()
    save_npz(path, arrays)


def load_train_state(path: str, device="cuda") -> TrainState:
    """The TrainState written by `save_train_state`, on `device`. Shapes
    (capacities, latent width) come from the file."""
    dev = resolve_device(device)
    data = load_npz(path)

    def group(prefix):
        n = len(prefix) + 1
        return {k[n:]: torch.from_numpy(np.array(v)).to(dev)
                for k, v in data.items() if k.startswith(prefix + ".")}

    leaves = group("params")
    net_sd = {k[len("timenet."):]: v for k, v in leaves.items()
              if k.startswith("timenet.")}
    net = TimeNet(int(net_sd["trunk.0.weight"].shape[1]) - input_dim(0))
    net.load_state_dict(net_sd)
    params = G.GaussianParams(
        **{f: leaves[f] for f in G.PARAM_FIELDS},
        latent={k[len("latent."):]: v for k, v in leaves.items()
                if k.startswith("latent.")},
        timenet=net.to(dev))
    aux = G.GaussianAux(**group("aux"))
    named = optim.named_leaves(params)
    for leaf in named.values():
        leaf.requires_grad_(True)
    mu, nu = group("mu"), group("nu")
    opt = optim.AdamState(mu={k: mu[k] for k in named},
                          nu={k: nu[k] for k in named},
                          step=torch.from_numpy(np.array(data["opt_step"])
                                                ).to(dev))
    rng = torch.Generator()
    rng.set_state(torch.from_numpy(np.array(data["rng_state"])))
    return TrainState(params=params, aux=aux, opt=opt,
                      step=int(data["step"]), rng=rng)
