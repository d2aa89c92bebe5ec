"""LPIPS perceptual distance (VGG16 backbone).

Counterpart of `dimo_tpu/models/lpips.py`, with the same public names and
the same pipeline, quirks included:

  * the inputs go through the scaling layer as they are: [0, 1] images
    into an LPIPS set up for [-1, 1] (the reference's normalize=False);
  * VGG16's 13 3x3 convolutions with SAME padding, a 2x2 max-pool before
    convolutions 2, 4, 7 and 10, taps after relu 1, 3, 6, 9 and 12;
  * each tap unit-normalised over channels with 1e-10 added to the norm,
    the squared difference weighted by a non-negative 1x1 head, the
    spatial mean, then the sum over the five taps.

Weights: an `.npz` with the reference's keys (`conv{i}_w` in (O, I, 3, 3),
`conv{i}_b`, `lin{k}_w`), or the seeded random-VGG fallback, drawn from
`np.random.RandomState(seed)` in the reference's order, so both packages
hold the same numbers. No weight is trained: `LPIPS` keeps them as
buffers, and the `lpips_fn`s below are closures over one such module on
an explicit device.

Precision: float32, forward and backward, on the card as on the CPU.
The reference runs these convolutions at `Precision.DEFAULT` on purpose,
to halve their cost (bf16 on the TPU, float32 on the CPU). The card's
counterpart would be TF32, which cuDNN uses for float32 convolutions when
it is allowed (its global default). Measured on an H100 (`chip_smoke.py`,
4 renders at 512^2 against their GT): TF32 keeps the distances within
8.5e-6 relative of float32 and is 2.6x faster, but moves the input
gradient by 7.05e-2 relative L2, outside the 5e-2 allowed before the
measurement, so float32 ships (`ROADMAP.md` Queue C). Each convolution is
an `autograd.Function` whose forward and backward both set cuDNN's TF32
flag for their own calls (`utils.general.cudnn_tf32`): the backward keeps
the forward's precision whatever the global flags are when
`loss.backward()` runs, and no global flag changes. The same context
restricts cuDNN to deterministic algorithms: the input gradient of one
LPIPS call computed twice differed by up to 2.8e-14 under cuDNN's default
pick (H100, `chip_smoke.py --phase determinism`), and is the same bits
under the restriction. `LPIPS(tf32=True)`
runs both passes in TF32 (the comparison above).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from dimo_tpu_torch.utils.general import cudnn_tf32, resolve_device

# VGG16 conv plan: (out_channels, pool_before)
_VGG_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
# indices (into the conv list) after whose relu the features are tapped
_TAPS = (1, 3, 6, 9, 12)
TAP_CHANNELS = (64, 128, 256, 512, 512)

_SHIFT = np.array([-.030, -.088, -.188], np.float32)
_SCALE = np.array([.458, .448, .450], np.float32)


class _Conv3x3(torch.autograd.Function):
    """3x3 convolution, stride 1, padding 1, whose forward and backward
    run with cuDNN's TF32 allowed exactly when `tf32` is true."""

    @staticmethod
    def forward(ctx, x, w, tf32: bool):
        ctx.tf32 = tf32
        ctx.x_shape = x.shape
        # the input is needed only for the weights' gradient
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        with cudnn_tf32(tf32):
            return F.conv2d(x, w, padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        with cudnn_tf32(ctx.tf32):
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(ctx.x_shape, w, g, padding=1)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, g, padding=1)
        return gx, gw, None


def vgg_features(params: dict, x: torch.Tensor,
                 tf32: bool = False) -> list[torch.Tensor]:
    """x: (B, 3, H, W) already scaled. Returns the 5 tapped feature maps.
    `tf32` applies to CUDA tensors only."""
    tf32 = bool(tf32 and x.is_cuda)
    feats = []
    h = x
    for i, (_, pool_before) in enumerate(_VGG_PLAN):
        if pool_before:
            h = F.max_pool2d(h, 2, 2)
        h = torch.relu(_Conv3x3.apply(h, params[f"conv{i}_w"], tf32)
                       + params[f"conv{i}_b"][None, :, None, None])
        if i in _TAPS:
            feats.append(h)
    return feats


def _unit_normalize(f, eps=1e-10):
    n = torch.sqrt(torch.sum(f * f, dim=1, keepdim=True))
    return f / (n + eps)


def lpips(params: dict, img1: torch.Tensor, img2: torch.Tensor,
          tf32: bool = False) -> torch.Tensor:
    """img1/img2: (B, 3, H, W) in [0, 1] (fed unnormalised, like the
    reference). Returns (B,) distances."""
    dev = img1.device
    shift = torch.as_tensor(_SHIFT, device=dev)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=dev)[None, :, None, None]
    f1 = vgg_features(params, (img1 - shift) / scale, tf32)
    f2 = vgg_features(params, (img2 - shift) / scale, tf32)
    total = 0.0
    for k, (a, b) in enumerate(zip(f1, f2)):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        w = params[f"lin{k}_w"]                     # (C,) non-negative
        val = torch.sum(d * w[None, :, None, None], dim=1, keepdim=True)
        total = total + torch.mean(val, dim=(1, 2, 3))
    return total


class LPIPS(torch.nn.Module):
    """The weights as buffers; calling it gives `lpips(weights, a, b)`."""

    def __init__(self, params: dict, tf32: bool = False):
        super().__init__()
        for k, v in params.items():
            self.register_buffer(k, torch.as_tensor(v, dtype=torch.float32))
        self.tf32 = tf32

    def weights(self) -> dict:
        return dict(self.named_buffers())

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        return lpips(self.weights(), img1, img2, self.tf32)


def _lpips_fn(params: dict, device):
    net = LPIPS(params).to(resolve_device(device))

    def lpips_fn(img1, img2):
        return net(img1, img2)
    return lpips_fn


def load_lpips(path: str, device="cuda"):
    """Converted weights -> lpips_fn(img1, img2), or None."""
    if not path or not os.path.exists(path):
        print(f"[WARN] LPIPS weights not found at {path!r}; LPIPS loss "
              "disabled")
        return None
    from dimo_tpu_torch.io.convert import lpips_params_from_numpy
    with np.load(path) as z:
        params = lpips_params_from_numpy({k: z[k] for k in z.files}, "cpu")
    return _lpips_fn(params, device)


def seeded_lpips_params(seed: int = 0) -> dict:
    """The deterministic random-VGG parameters of the no-weights fallback,
    as CPU tensors, bit-equal to the reference's: He-initialised filters
    from `np.random.RandomState(seed)` drawn in the same order, zero
    biases, uniform non-negative heads of 1/C."""
    rng = np.random.RandomState(seed)
    params = {}
    c_in = 3
    for i, (c_out, _) in enumerate(_VGG_PLAN):
        w = (rng.randn(c_out, c_in, 3, 3).astype(np.float32)
             * np.sqrt(2.0 / (c_in * 9)))
        params[f"conv{i}_w"] = torch.from_numpy(w.astype(np.float32))
        params[f"conv{i}_b"] = torch.zeros((c_out,), dtype=torch.float32)
        c_in = c_out
    for k, c in enumerate(TAP_CHANNELS):
        params[f"lin{k}_w"] = torch.full((c,), 1.0 / c, dtype=torch.float32)
    return params


def random_init_lpips(seed: int = 0, device="cuda"):
    """lpips_fn built from seeded_lpips_params (the fallback, and tests)."""
    return _lpips_fn(seeded_lpips_params(seed), device)


def get_lpips(path: str, fallback: str = "random", seed: int = 0,
              device="cuda"):
    """The training CLI's entry point: converted weights if present, else the
    fallback ('random') or None ('off')."""
    if path and os.path.exists(path):
        return load_lpips(path, device)
    if fallback == "random":
        print(f"[WARN] LPIPS weights not found at {path!r}; using the "
              "deterministic random-VGG perceptual fallback (see "
              "models/lpips.py docstring). Provide lpips_weights for exact "
              "reference parity.")
        return random_init_lpips(seed, device)
    print(f"[WARN] LPIPS weights not found at {path!r} and fallback={fallback!r}; "
          "LPIPS loss disabled")
    return None
