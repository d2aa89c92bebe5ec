"""One training step of the model, as the reference computes it.

A frozen copy of the program's s1/s2 step on one device, no VAE: the renders of the batch (motion-major), the loss (weighted MSE,
per-motion SSIM, LPIPS and mask MSE, edge-aware depth and bilateral
normal smoothness after their start steps, ARAP inside its window, the
chamfer guidance of the deformed control points in s2), autograd's
gradient, the non-finite guard, and Adam with the per-group learning
rates of the published schedule.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import arap as arap_mod
from . import image_losses as L
from . import neighbors, optim, schedules
from .render import find_knn, render


@dataclasses.dataclass(frozen=True)
class LossConfig:
    lambda_mse: float
    lambda_lpips: float
    lambda_ssim: float
    lambda_mask: float
    lambda_smooth: float
    lambda_bilateral: float
    lambda_arap: float
    lambda_ga1: float
    depth_reg_start_iter: int
    normal_reg_start_iter: int
    arap_start_iter_s1: int
    arap_end_iter_s2: int
    position_lr_init: float
    position_lr_final: float
    position_lr_max_steps: int
    c_position_lr_init: float
    c_position_lr_final: float
    latent_code_lr_init: float
    latent_code_lr_final: float
    deform_lr_init: float
    deform_lr_final: float
    feature_lr: float
    opacity_lr: float
    scaling_lr: float
    rotation_lr: float
    c_radius_lr: float
    r_lr: float
    arap_t_samples: int = 8
    arap_radius: float = 0.1


def loss_config(opt: dict, stage: str) -> LossConfig:
    """The loss and schedule of a stage from the published configuration,
    with its per-stage rewrites of the position schedule."""
    names = [f.name for f in dataclasses.fields(LossConfig)
             if f.name not in ("arap_t_samples", "arap_radius")
             and not f.name.startswith("position_lr")]
    kw = {k: opt[k] for k in names}
    if stage == "s1":
        kw.update(position_lr_init=opt["position_lr_init"],
                  position_lr_final=opt["position_lr_final"],
                  position_lr_max_steps=500)
    else:
        kw.update(position_lr_init=0.0002, position_lr_final=0.000002,
                  position_lr_max_steps=int(opt["iters_s2"]))
    return LossConfig(**kw)


def group_lrs(c: LossConfig, step: int, stage: str) -> dict:
    n = c.position_lr_max_steps
    xyz = schedules.expon_lr(c.position_lr_init, c.position_lr_final,
                             max_steps=n)
    cpos = schedules.expon_lr(c.c_position_lr_init, c.c_position_lr_final,
                              max_steps=n)
    lat = schedules.expon_lr(c.latent_code_lr_init, c.latent_code_lr_final,
                             max_steps=n)
    dfm = schedules.expon_lr(c.deform_lr_init, c.deform_lr_final, max_steps=n)
    if stage == "s1":
        lrs = {"xyz": xyz(step), "f_dc": c.feature_lr,
               "f_rest": c.feature_lr / 20.0, "opacity": c.opacity_lr,
               "scaling": c.scaling_lr, "rotation": c.rotation_lr,
               "latent_code": c.latent_code_lr_init,
               "deform": c.deform_lr_init, "deform_rot": c.deform_lr_init,
               "c_xyz": 0.0, "c_radius": 0.0, "r": c.r_lr}
    else:
        lrs = {"xyz": 0.0002 if step < 1000 else xyz(step),
               "f_dc": c.feature_lr, "f_rest": c.feature_lr / 20.0,
               "opacity": c.opacity_lr, "scaling": c.scaling_lr,
               "rotation": c.rotation_lr, "latent_code": lat(step),
               "deform": dfm(step), "deform_rot": dfm(step),
               "c_xyz": cpos(step), "c_radius": c.c_radius_lr, "r": 0.0}
    return {k: float(torch.as_tensor(v, dtype=torch.float32))
            for k, v in lrs.items()}


def motion_means(x: torch.Tensor, per: int) -> torch.Tensor:
    """(n_motions,) means of consecutive groups of `per` values."""
    return x.reshape(-1, per).mean(dim=1)


def loss_fn(params, batch: dict, step: int, c: LossConfig, stage: str,
            res: int, capacity: int, lpips_net, per: int,
            generator: torch.Generator):
    """(loss, terms) of one batch; `lpips_net` None leaves LPIPS out, as
    the program does without an `lpips_fn`. batch: "camera" (B Cameras), "times",
    "latent_idx", "mse_w", "gt_image" (B, S, S, 3) and "gt_mask" (B, S, S)
    uint8, "guidance" (B, Mc, 3) in s2; `per` renders a motion."""
    dev = params.xyz.device
    bg = torch.ones(3, device=dev)
    knn = find_knn(params) if stage >= "s2" else None
    b = len(batch["times"])
    tap = (torch.zeros((params.xyz.shape[0], 2), device=dev,
                       requires_grad=True) if stage == "s1" else None)
    outs = [render(params, batch["camera"][i], float(batch["times"][i]),
                   stage, int(batch["latent_idx"][i]), res, res, bg,
                   capacity, knn=knn, mean2d_tap=tap if i == b - 1 else None)
            for i in range(b)]
    stack = lambda k: torch.stack([o[k] for o in outs])       # noqa: E731
    imgs, masks = stack("image"), stack("alpha")
    gt = (torch.as_tensor(batch["gt_image"], device=dev).float()
          / 255.0).permute(0, 3, 1, 2)
    gt_m = (torch.as_tensor(batch["gt_mask"], device=dev).float()
            / 255.0)[:, None]
    if gt.shape[-1] != res:
        gt = F.interpolate(gt, size=(res, res), mode="bilinear",
                           align_corners=False, antialias=True)
        gt_m = F.interpolate(gt_m, size=(res, res), mode="bilinear",
                             align_corners=False, antialias=True)
    lp = (motion_means(lpips_net(imgs, gt), per) if lpips_net is not None
          else torch.zeros((b // per,), device=dev))
    per_img_mse = torch.mean((imgs - gt) ** 2, dim=(1, 2, 3))
    mse_w = torch.as_tensor(batch["mse_w"], dtype=torch.float32, device=dev)
    nhwc = lambda x: x.permute(0, 2, 3, 1)                    # noqa: E731
    groups = range(0, b, per)
    ssim_l = torch.stack([1.0 - L.ssim(nhwc(imgs[i:i + per]),
                                       nhwc(gt[i:i + per])) for i in groups])
    mask_l = torch.stack([torch.mean((masks[i:i + per] - gt_m[i:i + per]) ** 2)
                          for i in groups])
    smooth = torch.stack([L.edge_aware_smoothness(
        nhwc(stack("depth")[i:i + per]), nhwc(imgs[i:i + per]))
        for i in groups]).sum()
    bilat = torch.stack([L.bilateral_normal_smoothness(
        nhwc(stack("normal")[i:i + per]), nhwc(imgs[i:i + per]))
        for i in groups]).sum()
    loss = (c.lambda_mse * torch.sum(mse_w * per_img_mse)
            + c.lambda_ssim * ssim_l.sum() + c.lambda_lpips * lp.sum()
            + c.lambda_mask * mask_l.sum()
            + float(step > c.depth_reg_start_iter) * c.lambda_smooth * smooth
            + float(step > c.normal_reg_start_iter) * c.lambda_bilateral
            * bilat)
    if stage == "s1":
        gate = float(step > c.arap_start_iter_s1)
        base = params.xyz
    else:
        gate = float(step < c.arap_end_iter_s2)
        base = params.c_xyz
    times = torch.rand((c.arap_t_samples,), generator=generator)
    q = times.to(dev)[:, None, None]
    pts = base[None].expand(q.shape[0], *base.shape)
    arap = torch.zeros((), device=dev)
    for li in [int(i) for i in batch["latent_idx"][::per]]:
        d_xyz_t, _ = params.timenet(pts, q, params.latent["codes"][li])
        arap = arap + arap_mod.arap_loss(base, d_xyz_t, radius=c.arap_radius,
                                         generator=generator)
    loss = loss + gate * c.lambda_arap * arap
    ga = torch.zeros((), device=dev)
    if stage >= "s2":
        guid = torch.as_tensor(batch["guidance"], device=dev)
        for o, g in zip(outs, guid):
            ga = ga + neighbors.chamfer_forward(o["cpts_t"], g)
        loss = loss + c.lambda_ga1 * ga
    terms = {"mse": torch.mean(per_img_mse), "ssim_loss": ssim_l.mean(),
             "lpips": lp.mean(), "mask_loss": mask_l.mean(), "arap": arap,
             "ga": ga, "smooth": smooth, "bilateral": bilat}
    return loss, {k: v.detach() for k, v in terms.items()}, outs


def train_step(params, adam: optim.AdamState, step: int, batch: dict,
               c: LossConfig, stage: str, res: int, capacity: int, lpips_net,
               per: int, generator: torch.Generator):
    """Adam's step `step` (1-based, the stage's count) over `batch`, in
    place on `params`. Returns (adam, loss, terms, grads)."""
    leaves = optim.named_leaves(params)
    for leaf in leaves.values():
        leaf.grad = None
    loss, terms, _ = loss_fn(params, batch, step, c, stage, res, capacity,
                             lpips_net, per, generator)
    loss.backward()
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
    return adam, loss.detach(), terms, grads
