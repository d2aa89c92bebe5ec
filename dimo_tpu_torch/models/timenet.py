"""TimeNet: the latent-conditioned deformation MLP (nn.Module).

Counterpart of `dimo_tpu/models/timenet.py` (its `apply_timenet(params,
pts, t, latent)` is `net(pts, t, latent)` here):
  * input = posenc(xyz, 10 freqs) ++ posenc(t, 6 freqs) ++ latent = 92 + L;
  * 8 hidden layers of width 256, ReLU, skip-concat of the input after
    layer index 4;
  * two heads (W->W->ReLU->out): delta-xyz (zero-init last layer) and
    delta-quat (zero weights, bias [1,0,0,0] so rotation starts at identity).

Init follows the reference's distributions (xavier-uniform weights, biases
U(+-1/sqrt(fan_in))) drawn from an explicit `torch.Generator`; the numbers
differ from the JAX package's, whose keys are `jax.random` keys. Weights
carried over from JAX go through `io/convert.params_from_numpy`, which
transposes the (fan_in, fan_out) leaves into `nn.Linear`'s (out, in).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from dimo_tpu_torch.ops.posenc import posenc, posenc_dim
from dimo_tpu_torch.utils import diagnostics

PTS_FREQS = 10
TIME_FREQS = 6
DEPTH = 8
WIDTH = 256
SKIPS = (4,)


def input_dim(latent_dim: int) -> int:
    return posenc_dim(PTS_FREQS, 3) + posenc_dim(TIME_FREQS, 1) + latent_dim


def _init_linear(lin: nn.Linear, gen: torch.Generator) -> None:
    fan_out, fan_in = lin.weight.shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        lin.weight.uniform_(-limit, limit, generator=gen)
        lin.bias.uniform_(-bound, bound, generator=gen)


class TimeNet(nn.Module):
    """Deformation MLP; `forward(pts, t, latent) -> (d_xyz, d_quat)`."""

    def __init__(self, latent_dim: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        in_ch = input_dim(latent_dim)
        dims_in = [in_ch] + [WIDTH + in_ch if (i - 1) in SKIPS else WIDTH
                             for i in range(1, DEPTH)]
        self.trunk = nn.ModuleList(nn.Linear(d, WIDTH) for d in dims_in)
        self.pts_0 = nn.Linear(WIDTH, WIDTH)
        self.pts_1 = nn.Linear(WIDTH, 3)
        self.rot_0 = nn.Linear(WIDTH, WIDTH)
        self.rot_1 = nn.Linear(WIDTH, 4)
        gen = generator if generator is not None else torch.Generator()
        for lin in (*self.trunk, self.pts_0, self.rot_0):
            _init_linear(lin, gen)
        with torch.no_grad():
            self.pts_1.weight.zero_()
            self.pts_1.bias.zero_()
            self.rot_1.weight.zero_()
            self.rot_1.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0]))

    def forward(self, pts: torch.Tensor, t, latent: torch.Tensor):
        """pts (..., 3); t a scalar or (..., 1); latent (..., L); see
        `embed`. Returns (d_xyz (..., 3), d_quat (..., 4))."""
        return self.mlp(self.embed(pts, t, latent))

    def embed(self, pts: torch.Tensor, t, latent: torch.Tensor):
        """The MLP's input, (..., 92 + L). The batch shape is the three's
        broadcast, so pts (M, 3), t (R, 1, 1) and latent (R, 1, L) give R
        renders' inputs at once, each point's encoding made once."""
        with diagnostics.host_wait("timenet_time", not torch.is_tensor(t)):
            t = torch.as_tensor(t, dtype=pts.dtype, device=pts.device)
        t = t.reshape(t.shape or (1,))
        # numpy's rule: torch.broadcast_shapes imports sympy on first use
        batch = np.broadcast_shapes(pts.shape[:-1], t.shape[:-1],
                                    latent.shape[:-1])
        parts = (posenc(pts, PTS_FREQS), posenc(t, TIME_FREQS), latent)
        return torch.cat([x.expand(*batch, x.shape[-1]) for x in parts],
                         dim=-1)

    def mlp(self, emb: torch.Tensor):
        """(d_xyz (..., 3), d_quat (..., 4)) of an `embed` input."""
        h = emb
        for i, lin in enumerate(self.trunk):
            h = torch.relu(lin(h))
            if i in SKIPS:
                h = torch.cat([emb, h], dim=-1)
        d_xyz = self.pts_1(torch.relu(self.pts_0(h)))
        d_quat = self.rot_1(torch.relu(self.rot_0(h)))
        return d_xyz, d_quat
