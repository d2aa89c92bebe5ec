"""Per-group Adam with schedule-driven learning rates.

Counterpart of `dimo_tpu/train/optim.py`. The parameters are addressed as
a flat dict of named leaves (`named_leaves`: the tensor fields of
`GaussianParams`, `latent.<key>` and `timenet.<parameter name>`), and the
moments are dicts with the same keys.

The update is the reference's formula exactly, in float32:
    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
    p = p - lr (m / bc1) / (sqrt(v / bc2) + 1e-15),  bc_i = 1 - b_i^t
with the bias corrections taken as float32 powers. `torch.optim.Adam` puts
eps and the corrections elsewhere, so it is not used.
"""
from __future__ import annotations

import dataclasses

import torch

from dimo_tpu_torch.models.gaussians import PARAM_FIELDS

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15

_SIMPLE = {"xyz": "xyz", "features_dc": "f_dc", "features_rest": "f_rest",
           "scaling": "scaling", "rotation": "rotation", "opacity": "opacity",
           "c_xyz": "c_xyz", "c_radius": "c_radius", "r": "r"}
_LATENT = {"codes": "latent_code", "mu": "latent_code_mu",
           "log_var": "latent_code_log_var"}


@dataclasses.dataclass
class AdamState:
    mu: dict            # name -> first moment
    nu: dict            # name -> second moment
    step: torch.Tensor  # () int32 on the parameters' device


def named_leaves(params) -> dict:
    """{name: tensor} of every learnable leaf of a GaussianParams."""
    leaves = {f: getattr(params, f) for f in PARAM_FIELDS}
    leaves.update({f"latent.{k}": v for k, v in params.latent.items()})
    if params.timenet is not None:
        leaves.update({f"timenet.{k}": v
                       for k, v in params.timenet.named_parameters()})
    return leaves


def leaf_group(name: str) -> str:
    """The reference's param-group name of a leaf: TimeNet's `rot_*`
    layers are `deform_rot`, the rest of TimeNet `deform`."""
    top, _, sub = name.partition(".")
    if top in _SIMPLE and not sub:
        return _SIMPLE[top]
    if top == "latent" and sub in _LATENT:
        return _LATENT[sub]
    if top == "timenet":
        return "deform_rot" if sub.startswith("rot_") else "deform"
    raise KeyError(f"unknown param leaf {name}")


def init(leaves: dict) -> AdamState:
    some = next(iter(leaves.values()))
    return AdamState(
        mu={k: torch.zeros_like(v, requires_grad=False) for k, v in leaves.items()},
        nu={k: torch.zeros_like(v, requires_grad=False) for k, v in leaves.items()},
        step=torch.zeros((), dtype=torch.int32, device=some.device))


@torch.no_grad()
def update(leaves: dict, grads: dict, state: AdamState,
           lrs: dict) -> tuple[dict, AdamState]:
    """One Adam step; returns (new leaf values, new state) and changes
    nothing in place. lrs: {name: float} learning rate per leaf."""
    step = state.step + 1
    t = step.to(torch.float32)
    b1 = torch.tensor(BETA1, dtype=torch.float32, device=t.device)
    b2 = torch.tensor(BETA2, dtype=torch.float32, device=t.device)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    mu, nu, new = {}, {}, {}
    for k, p in leaves.items():
        g = grads[k]
        mu[k] = BETA1 * state.mu[k] + (1 - BETA1) * g
        nu[k] = BETA2 * state.nu[k] + (1 - BETA2) * g * g
        mhat = mu[k] / bc1
        vhat = nu[k] / bc2
        new[k] = p - lrs[k] * mhat / (torch.sqrt(vhat) + EPS)
    return new, AdamState(mu=mu, nu=nu, step=step)
