"""One training step of the model, as the reference computes it, with its
gradient accumulated a motion at a time, so that it fits one card at the
published batch (8 motions x 4 views x 4 frames = 128 renders at 512^2).

The same step as `step.py`, whose configuration, schedule and motion
means it imports: for each motion of the batch, in the batch's order,
that motion's per-job renders, its LPIPS, MSE, SSIM, mask and smoothness
terms, its chamfer guidance and its ARAP share, then their backward,
after which the motion's graph is freed. The KNN and ARAP's times are
taken once, before the first motion; the motions draw ARAP's samples in
the batch's order, so the generator gives each motion the numbers
`step.py` gives it. Then the same non-finite guard and Adam.

Departure from `step.py`: the loss is the sum of the motions' parts and
each leaf's gradient the sum of the motions' backwards, in the motions'
order, where `step.py` adds each kind of term over the motions first and
runs one backward; the two differ by the rounding of that order (float32,
TF32 off).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import arap as arap_mod
from . import image_losses as L
from . import neighbors, optim
from .render import find_knn, render
# `loss_config` too, so that this module serves where `step.py` does
from .step import (LossConfig, group_lrs, loss_config,  # noqa: F401
                   motion_means)


def loss_and_grad(params, batch: dict, step: int, c: LossConfig, stage: str,
                  res: int, capacity: int, lpips_net, per: int,
                  generator: torch.Generator):
    """(loss, terms) of one batch as `step.loss_fn` gives them, with the
    loss's gradient added into the leaves' `.grad`, one motion's `per`
    renders at a time; the arguments are `step.loss_fn`'s."""
    dev = params.xyz.device
    bg = torch.ones(3, device=dev)
    knn = find_knn(params) if stage >= "s2" else None
    b = len(batch["times"])
    tap = (torch.zeros((params.xyz.shape[0], 2), device=dev,
                       requires_grad=True) if stage == "s1" else None)
    if stage == "s1":
        gate = float(step > c.arap_start_iter_s1)
        base = params.xyz
    else:
        gate = float(step < c.arap_end_iter_s2)
        base = params.c_xyz
    times = torch.rand((c.arap_t_samples,), generator=generator)
    q = times.to(dev)[:, None, None]
    mse_w = torch.as_tensor(batch["mse_w"], dtype=torch.float32, device=dev)
    guid = (torch.as_tensor(batch["guidance"], device=dev)
            if stage >= "s2" else None)
    nhwc = lambda x: x.permute(0, 2, 3, 1)                    # noqa: E731
    loss = torch.zeros((), device=dev)
    parts = {k: [] for k in ("mse", "ssim_loss", "lpips", "mask_loss", "arap",
                             "ga", "smooth", "bilateral")}
    for lo in range(0, b, per):
        hi = lo + per
        outs = [render(params, batch["camera"][i], float(batch["times"][i]),
                       stage, int(batch["latent_idx"][i]), res, res, bg,
                       capacity, knn=knn,
                       mean2d_tap=tap if i == b - 1 else None)
                for i in range(lo, hi)]
        stack = lambda k: torch.stack([o[k] for o in outs])   # noqa: E731
        imgs, masks = stack("image"), stack("alpha")
        gt = (torch.as_tensor(batch["gt_image"][lo:hi], device=dev).float()
              / 255.0).permute(0, 3, 1, 2)
        gt_m = (torch.as_tensor(batch["gt_mask"][lo:hi], device=dev).float()
                / 255.0)[:, None]
        if gt.shape[-1] != res:
            gt = F.interpolate(gt, size=(res, res), mode="bilinear",
                               align_corners=False, antialias=True)
            gt_m = F.interpolate(gt_m, size=(res, res), mode="bilinear",
                                 align_corners=False, antialias=True)
        lp = (motion_means(lpips_net(imgs, gt), per)[0]
              if lpips_net is not None else torch.zeros((), device=dev))
        per_img_mse = torch.mean((imgs - gt) ** 2, dim=(1, 2, 3))
        ssim_l = 1.0 - L.ssim(nhwc(imgs), nhwc(gt))
        mask_l = torch.mean((masks - gt_m) ** 2)
        smooth = L.edge_aware_smoothness(nhwc(stack("depth")), nhwc(imgs))
        bilat = L.bilateral_normal_smoothness(nhwc(stack("normal")),
                                              nhwc(imgs))
        pts = base[None].expand(q.shape[0], *base.shape)
        d_xyz_t, _ = params.timenet(
            pts, q, params.latent["codes"][int(batch["latent_idx"][lo])])
        arap = arap_mod.arap_loss(base, d_xyz_t, radius=c.arap_radius,
                                  generator=generator)
        ga = torch.zeros((), device=dev)
        if stage >= "s2":
            for o, g in zip(outs, guid[lo:hi]):
                ga = ga + neighbors.chamfer_forward(o["cpts_t"], g)
        part = (c.lambda_mse * torch.sum(mse_w[lo:hi] * per_img_mse)
                + c.lambda_ssim * ssim_l + c.lambda_lpips * lp
                + c.lambda_mask * mask_l
                + float(step > c.depth_reg_start_iter) * c.lambda_smooth
                * smooth
                + float(step > c.normal_reg_start_iter) * c.lambda_bilateral
                * bilat
                + gate * c.lambda_arap * arap + c.lambda_ga1 * ga)
        part.backward()
        loss = loss + part.detach()
        for k, v in (("mse", per_img_mse), ("ssim_loss", ssim_l),
                     ("lpips", lp), ("mask_loss", mask_l), ("arap", arap),
                     ("ga", ga), ("smooth", smooth), ("bilateral", bilat)):
            parts[k].append(v.detach().reshape(-1))
        del outs, imgs, masks, part
    cat = {k: torch.cat(v) for k, v in parts.items()}
    terms = {k: (cat[k].mean() if k in ("mse", "ssim_loss", "lpips",
                                        "mask_loss") else cat[k].sum())
             for k in cat}
    return loss, terms


def train_step(params, adam: optim.AdamState, step: int, batch: dict,
               c: LossConfig, stage: str, res: int, capacity: int, lpips_net,
               per: int, generator: torch.Generator):
    """`step.train_step` with the gradient of `loss_and_grad`. Returns
    (adam, loss, terms, grads)."""
    leaves = optim.named_leaves(params)
    for leaf in leaves.values():
        leaf.grad = None
    loss, terms = loss_and_grad(params, batch, step, c, stage, res, capacity,
                                lpips_net, per, generator)
    with torch.no_grad():
        grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
                 for k, v in leaves.items()}
        ok = all(bool(torch.isfinite(g).all()) for g in grads.values()) and \
            max(float(g.abs().max()) for g in grads.values() if g.numel()) < 1e17
        if ok:
            lr_g = group_lrs(c, step, stage)
            lrs = {k: lr_g[optim.leaf_group(k)] for k in leaves}
            new, adam = optim.update(leaves, grads, adam, lrs)
            for k, p in leaves.items():
                p.copy_(new[k])
        for leaf in leaves.values():
            leaf.grad = None
    return adam, loss, terms, grads
