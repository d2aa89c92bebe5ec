"""LPIPS perceptual distance (VGG16 backbone).

Frozen from the program's `models/lpips.py` (the JAX package's counterpart), with the same public names and
the same pipeline, quirks included:

  * the inputs go through the scaling layer as they are: [0, 1] images
    into an LPIPS set up for [-1, 1] (the reference's normalize=False);
  * VGG16's 13 3x3 convolutions with SAME padding, a 2x2 max-pool before
    convolutions 2, 4, 7 and 10, taps after relu 1, 3, 6, 9 and 12;
  * each tap unit-normalised over channels with 1e-10 added to the norm,
    the squared difference weighted by a non-negative 1x1 head, the
    spatial mean, then the sum over the five taps.

Weights: the reference's keys (`conv{i}_w` in (O, I, 3, 3), `conv{i}_b`,
`lin{k}_w`), given by the caller; `LPIPS` keeps them as buffers.

Precision: float32, forward and backward. Each convolution is an
`autograd.Function` whose forward and backward set cuDNN's TF32 flag for
their own calls and pick deterministic algorithms (`general.cudnn_tf32`);
TF32 runs where the caller asks (`LPIPS(tf32=True)`) or where the process
allows it in matmuls (the control).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .general import cudnn_tf32

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
