"""Image-space losses of the train step (plain tensor ops, autograd).

Counterpart of `dimo_tpu/ops/image_losses.py`: `ssim`,
`edge_aware_smoothness`, `bilateral_normal_smoothness` and `psnr` (the
train step's), and `tv_norm`, the Pearson depth losses, `l1_loss` and
`mse_loss` (no caller yet, as in the reference).
Images keep the reference's NHWC layout (B, H, W, C) at every function
boundary, so the two packages are compared like with like; the blur works
on NCHW inside.

Precision: SSIM subtracts blurred squares (sigma^2 = blur(x^2) - mu^2), a
cancellation that TF32's ~3 decimal digits destroy. The reference forces
float32; here the depthwise blur runs with cuDNN's TF32 off, in the
forward and in the backward alike (the blur is its own adjoint), through a
scoped `utils.general.cudnn_tf32(False)` that restores every global flag
(and picks deterministic algorithms only).
Differences of pixels use `jnp.abs`'s slope +1 at 0 (flat depth and
equal colours give exact zeros).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dimo_tpu_torch.ops import grad_conventions as gc
from dimo_tpu_torch.utils.general import cudnn_tf32


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur_nchw(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable depthwise blur of (B, C, H, W) with SAME zero padding."""
    c, k = x.shape[1], win.shape[0]
    kh = win.reshape(1, 1, k, 1).expand(c, 1, k, 1)
    kw = win.reshape(1, 1, 1, k).expand(c, 1, 1, k)
    with cudnn_tf32(False):
        out = F.conv2d(x, kh, padding=(k // 2, 0), groups=c)
        return F.conv2d(out, kw, padding=(0, k // 2), groups=c)


class _Blur(torch.autograd.Function):
    """The blur is linear and self-adjoint (a symmetric window with zero
    padding along each axis), so its backward is the same blur, run under
    the same precision."""

    @staticmethod
    def forward(ctx, x, win):
        ctx.save_for_backward(win)
        return _blur_nchw(x, win)

    @staticmethod
    def backward(ctx, g):
        (win,) = ctx.saved_tensors
        return _blur_nchw(g.contiguous(), win), None


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over a batch; img: (B, H, W, C) in [0, 1]."""
    win = torch.as_tensor(_gaussian_window(window_size), device=img1.device)
    a = img1.permute(0, 3, 1, 2)
    b = img2.permute(0, 3, 1, 2)
    blur = lambda t: _Blur.apply(t.contiguous(), win)  # noqa: E731
    mu1 = blur(a)
    mu2 = blur(b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = blur(a * a) - mu1_sq
    sigma2_sq = blur(b * b) - mu2_sq
    sigma12 = blur(a * b) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def _grads(t: torch.Tensor):
    """|horizontal| and |vertical| neighbour differences of (B, H, W, C)."""
    return (gc.abs(t[..., :, :-1, :] - t[..., :, 1:, :]),
            gc.abs(t[..., :-1, :, :] - t[..., 1:, :, :]))


def edge_aware_smoothness(depth: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Edge-aware depth smoothness; depth (B, H, W, 1), rgb (B, H, W, 3)."""
    gdx, gdy = _grads(depth)
    gix, giy = (torch.mean(g, -1, keepdim=True) for g in _grads(rgb))
    return torch.mean(gdx * torch.exp(-gix)) + torch.mean(gdy * torch.exp(-giy))


def bilateral_normal_smoothness(normal: torch.Tensor,
                                rgb: torch.Tensor) -> torch.Tensor:
    """Bilateral normal smoothness; normal (B, H, W, 3), rgb (B, H, W, 3).
    Keeps the reference's order: the image-gradient attenuation comes
    before the sqrt(1 + g^2) transform."""
    gnx, gny = _grads(normal)
    gix, giy = (torch.mean(g, -1, keepdim=True) for g in _grads(rgb))
    gnx = gnx * torch.exp(-3.0 * gix)
    gny = gny * torch.exp(-3.0 * giy)
    return (torch.mean(torch.sqrt(1.0 + gnx ** 2))
            + torch.mean(torch.sqrt(1.0 + gny ** 2)))


def tv_norm(values: torch.Tensor, losstype: str = "l2") -> torch.Tensor:
    """Total-variation map (RegNeRF-style); values (B, H, W, C)."""
    v00 = values[..., :-1, :-1, :]
    v01 = values[..., :-1, 1:, :]
    v10 = values[..., 1:, :-1, :]
    if losstype == "l2":
        return ((v00 - v01) ** 2) + ((v00 - v10) ** 2)
    if losstype == "l1":
        return gc.abs(v00 - v01) + gc.abs(v00 - v10)
    raise ValueError(f"losstype must be l2 or l1 but is {losstype}")


def pearson_depth_loss(render_depth: torch.Tensor,
                       gt_depth: torch.Tensor) -> torch.Tensor:
    """1 - Pearson correlation between flattened depths (population
    standard deviations, as `jnp.std`)."""
    src = render_depth - torch.mean(render_depth)
    tgt = gt_depth - torch.mean(gt_depth)
    src = src / (torch.std(src, correction=0) + 1e-6)
    tgt = tgt / (torch.std(tgt, correction=0) + 1e-6)
    return 1.0 - torch.mean(src * tgt)


def pearson_patches(render_depth: torch.Tensor, gt_depth: torch.Tensor,
                    x0, y0, box_p: int) -> torch.Tensor:
    """Mean over patches of `pearson_depth_loss`; the patch i is the
    box_p x box_p square at (x0[i], y0[i]) of the (H, W) depths."""
    return torch.mean(torch.stack([
        pearson_depth_loss(render_depth[x:x + box_p, y:y + box_p].reshape(-1),
                           gt_depth[x:x + box_p, y:y + box_p].reshape(-1))
        for x, y in zip(x0, y0)]))


def local_pearson_depth_loss(render_depth: torch.Tensor,
                             gt_depth: torch.Tensor,
                             generator: torch.Generator | None = None,
                             box_p: int = 128,
                             p_corr: float = 0.5) -> torch.Tensor:
    """Patchwise Pearson depth loss: random box_p-sized patches covering
    about p_corr of the (H, W) image, the mean of their (1 - correlation).
    The corners come from `generator` (the reference draws them from a
    JAX key, so the patches are not the reference's)."""
    h, w = render_depth.shape
    n_corr = max(1, int(p_corr * (h // box_p) * (w // box_p)))
    x0 = torch.randint(0, max(1, h - box_p), (n_corr,), generator=generator)
    y0 = torch.randint(0, max(1, w - box_p), (n_corr,), generator=generator)
    return pearson_patches(render_depth, gt_depth, x0.tolist(), y0.tolist(),
                           box_p)


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(gc.abs(pred - gt))


def mse_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def psnr(mse: torch.Tensor) -> torch.Tensor:
    """PSNR from the MSE of [0, 1] images."""
    return 10.0 * torch.log10(1.0 / mse)
