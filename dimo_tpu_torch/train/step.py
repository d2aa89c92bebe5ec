"""One training step: renders, loss assembly, backward, per-group Adam.

Counterpart of `dimo_tpu/train/step.py`, stages s1 and s2. The reference
jits the whole step and maps the renders sequentially (`lax.map`); here
this rank's renders run in one pass (`models/renderer.py::render_batch`)
along a leading render axis in the same motion-major order, autograd
records it, and one `backward` runs the compositor and LBS-gather
backward kernels (K3, K4) for every render.

Loss (the reference's `loss_fn`, same weights and gates):
  * per-image weighted MSE, per-motion SSIM and mask MSE, KL when `vae`;
  * with an `lpips_fn`, `lambda_lpips` times the sum over motions of the
    mean LPIPS distance of the motion's renders to their GT. The
    reference maps over the motions (`lax.map`, with a `jax.checkpoint`
    that bounds memory on 16 GB of HBM and changes no value); here LPIPS
    runs on chunks of whole motions (this rank's renders of them) of at
    most `LPIPS_PIXELS` pixels, and each chunk's forward and input VJP
    run together on detached renders, so the peak holds one chunk of VGG
    activations and not the batch's (at the published batch_size 4, 32
    renders of 128 at 512^2). The summed image gradient joins the step's
    one backward through the other losses and the render pass
    (`_InputGrad`); the GT tower records no gradient;
  * edge-aware depth and bilateral normal smoothness, gated by
    step > depth/normal_reg_start_iter;
  * ARAP over `arap_t_samples` TimeNet times: in s2 on the control
    points, gated by step < arap_end_iter_s2; in s1 on the Gaussians
    themselves (they are the control points), gated by
    step > arap_start_iter_s1;
  * chamfer guidance of the deformed control points to the batch's
    stage-1 trajectories (`use_guidance`, s2).
Test-time fine-tuning (`trainable_groups`, a set of optimizer groups):
every other group gets learning rate 0, the latent groups follow the
latent schedule, and ARAP is off.
Then the non-finite guard (every gradient finite and sup|g| < 1e17,
taken before the optional global-norm clip, as in the reference), and
Adam on `where(grads_ok, new, old)`; a skipped step leaves parameters,
moments and the Adam step count as they were.

Stage s1 skips the KNN (no skinning) and gathers the densification
statistics: the last render of the batch carries a `mean2d_tap`, and its
gradient, radii and visibility go into `xyz_grad_accum`, `denom` and
`max_radii2d` when step % fps_iter >= density_start_iter and
step <= density_end_iter. As in the reference, a step skipped by the
non-finite guard still accumulates them.

Batch (B = n_motions * n_views * n_frames, motion-major, then view, then
frame): "camera" a list of B `utils.cameras.Camera`; "times" (B,) and
"latent_idx" (B,) on the host; "mse_w" (B,); "gt_image" (B, S, S', 3) and
"gt_mask" (B, S, S') uint8; "guidance" (B, M, 3); optionally
"latent_idx_all", the latent indices of the whole batch when the batch
holds one rank's share of it (`parallel/mesh.py::shard_batch`). A GT of another size
than the render is resized on the device as `jax.image.resize(...,
"linear")` does it: half-pixel centres, and a triangle filter widened by
the scale when it shrinks (`F.interpolate` with `antialias=True`,
measured within 3e-7 of the reference). Same-size GT is used as it is.

Data parallelism (`mesh`, `parallel/mesh.py`): each rank holds the same
state and its contiguous B / N jobs of the batch. Its loss is the part of
the global loss that its jobs carry: a per-motion mean over the motion's
images becomes the mean over the rank's images of that motion times
their share of the motion (a motion may straddle two ranks), and the
terms of the parameters alone (KL, ARAP) are added by rank 0 only. Every
rank draws the same random numbers in the same order: the VAE noise of
every job of the batch (a rank draws and drops the noise of the jobs it
does not render, so job b's noise does not depend on N), the ARAP times
and samples. The gradients are summed over ranks before the non-finite
guard and the clip, so every rank takes the same decision and the same
update; the densification statistics of the batch's last render are
broadcast from the rank that rendered it; the metrics are those of the
whole batch (sums over ranks, `overflow_max` the maximum).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from dimo_tpu_torch.models import gaussians as G
from dimo_tpu_torch.models import lpips as lpips_mod
# `render` here is the pass, `render_batch` (R jobs, (R, ...) outputs), not
# `models.renderer.render`: the benchmark's fault test plants a fault in
# every render of a step by patching `step.render`. To be renamed once
# that test patches `step.render_batch`.
from dimo_tpu_torch.models.renderer import find_knn, render_batch as render
from dimo_tpu_torch.ops import arap as arap_mod
from dimo_tpu_torch.ops import grad_conventions as gc
from dimo_tpu_torch.ops import image_losses as L
from dimo_tpu_torch.ops import neighbors
from dimo_tpu_torch.parallel import mesh as mesh_mod
from dimo_tpu_torch.train import optim
from dimo_tpu_torch.utils import diagnostics, schedules

# LPIPS's pixels a call (32 renders at 512^2): whole motions are chunked
# under it. On an H100 a chunk's VGG forward and input VJP hold ~22 GiB
# at 32 renders and take 14.3 ms a render, as at 54 (14.3); one motion a
# call would take 16.3 ms a render at 16 renders, 19.4 at 9, 23.1 at 4.
LPIPS_PIXELS = 32 * 512 * 512


class _InputGrad(torch.autograd.Function):
    """A zero whose backward hands `g` to `x`: the LPIPS term's gradient
    with respect to the renders, taken chunk by chunk in the forward,
    joins the one backward through the rest of the loss and the render
    pass, as `torch.autograd.backward((loss_rest, imgs), (None, g))`
    would, and a caller's `loss.backward()` stays the whole gradient."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.save_for_backward(g)
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, dz):
        (g,) = ctx.saved_tensors
        return g * dz, None


@dataclasses.dataclass
class TrainState:
    params: G.GaussianParams
    aux: G.GaussianAux
    opt: optim.AdamState
    step: int                  # stage-local step, 1-based after an update
    rng: torch.Generator       # ARAP times (and VAE noise) on the host


def init_state(params: G.GaussianParams, aux: G.GaussianAux, step: int = 0,
               seed: int = 0) -> TrainState:
    """A TrainState with zero moments; marks every leaf as trainable."""
    leaves = optim.named_leaves(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    return TrainState(params=params, aux=aux, opt=optim.init(leaves),
                      step=step, rng=torch.Generator().manual_seed(seed))


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss and schedule hyper-parameters (the reference's, same defaults)."""
    lambda_mse: float = 5000.0
    lambda_lpips: float = 1000.0
    lambda_ssim: float = 500.0
    lambda_mask: float = 500.0
    lambda_smooth: float = 100.0
    lambda_bilateral: float = 0.05
    lambda_arap: float = 10.0
    lambda_kl: float = 0.05
    lambda_ga1: float = 10.0
    lambda_ga2: float = 10000.0
    grad_clip_norm: float = 0.0
    add_depth: bool = True
    add_normal: bool = True
    add_ga: bool = True
    ga_chamfer: bool = True
    use_arap: bool = True
    vae: bool = False
    depth_reg_start_iter: int = 200
    normal_reg_start_iter: int = 200
    arap_start_iter_s1: int = 1000
    arap_end_iter_s2: int = 2000
    fps_iter: int = 1000
    density_start_iter: int = 100
    density_end_iter: int = 1000
    position_lr_init: float = 0.01
    position_lr_final: float = 0.0002
    position_lr_max_steps: int = 500
    c_position_lr_init: float = 0.000002
    c_position_lr_final: float = 0.000002
    latent_code_lr_init: float = 0.005
    latent_code_lr_final: float = 0.0002
    deform_lr_init: float = 0.0002
    deform_lr_final: float = 0.000002
    feature_lr: float = 0.01
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.005
    c_radius_lr: float = 0.005
    r_lr: float = 0.01
    arap_t_samples: int = 8
    arap_radius: float = 0.1


def group_lrs(lcfg: LossConfig, step: int, stage: str,
              trainable_groups: frozenset | None = None) -> dict:
    """{group: lr as a float32 value} at `step`: the reference's
    update_learning_rate with its stage overrides. With
    `trainable_groups` (test-time fine-tuning), every group outside the
    set gets 0 and the latent groups follow the latent schedule."""
    n = lcfg.position_lr_max_steps
    xyz_sched = schedules.expon_lr(lcfg.position_lr_init,
                                   lcfg.position_lr_final, max_steps=n)
    c_sched = schedules.expon_lr(lcfg.c_position_lr_init,
                                 lcfg.c_position_lr_final, max_steps=n)
    lat_sched = schedules.expon_lr(lcfg.latent_code_lr_init,
                                   lcfg.latent_code_lr_final, max_steps=n)
    def_sched = schedules.expon_lr(lcfg.deform_lr_init, lcfg.deform_lr_final,
                                   max_steps=n)
    f = lambda x: float(torch.as_tensor(x, dtype=torch.float32))  # noqa: E731
    if stage == "s1":
        lrs = {
            "xyz": xyz_sched(step),
            "f_dc": lcfg.feature_lr, "f_rest": lcfg.feature_lr / 20.0,
            "opacity": lcfg.opacity_lr, "scaling": lcfg.scaling_lr,
            "rotation": lcfg.rotation_lr,
            "latent_code": lcfg.latent_code_lr_init,
            "latent_code_mu": lcfg.latent_code_lr_init,
            "latent_code_log_var": lcfg.latent_code_lr_init,
            "deform": lcfg.deform_lr_init, "deform_rot": lcfg.deform_lr_init,
            "c_xyz": 0.0, "c_radius": 0.0, "r": lcfg.r_lr,
        }
    else:
        lrs = {
            "xyz": 0.0002 if step < 1000 else xyz_sched(step),
            "f_dc": lcfg.feature_lr, "f_rest": lcfg.feature_lr / 20.0,
            "opacity": lcfg.opacity_lr, "scaling": lcfg.scaling_lr,
            "rotation": lcfg.rotation_lr,
            "latent_code": lat_sched(step),
            "latent_code_mu": lat_sched(step),
            "latent_code_log_var": lat_sched(step),
            "deform": def_sched(step), "deform_rot": def_sched(step),
            "c_xyz": c_sched(step), "c_radius": lcfg.c_radius_lr, "r": 0.0,
        }
    if trainable_groups is not None:
        latents = {"latent_code", "latent_code_mu", "latent_code_log_var"}
        lrs = {k: ((lat_sched(step) if k in latents else lrs[k])
                   if k in trainable_groups else 0.0) for k in lrs}
    return {k: f(v) for k, v in lrs.items()}


def resize_linear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, C, h, w) -> (B, C, height, width) as `jax.image.resize(...,
    "linear")`: half-pixel centres, antialiased where it shrinks."""
    return F.interpolate(x, size=(height, width), mode="bilinear",
                         align_corners=False, antialias=True)


def make_train_step(
    cfg: G.ModelConfig,
    lcfg: LossConfig,
    stage: str,
    width: int,
    height: int,
    n_motions: int,
    n_views: int,
    n_frames: int,
    capacity: int = 512,
    lpips_fn: Callable | None = None,
    use_guidance: bool = False,
    trainable_groups: frozenset | None = None,
    mesh: mesh_mod.Mesh | None = None,
) -> Callable:
    """The step for a fixed (stage, resolution, batch shape):
    `train_step(state, batch, arap_times=None, mark=None)` updates `state`
    in place and returns (state, metrics). `arap_times` (arap_t_samples,)
    replaces the times drawn from `state.rng`; `mark(name)`, if given, is
    called after the renders, the LPIPS term (with an `lpips_fn`; its
    interval also holds the GT's conversion and LPIPS's input gradient),
    the other losses, the backward and the update (e.g. to record CUDA
    events). With `utils/diagnostics.py`'s recorder on, the same five
    intervals, from the step's start, are spans of those names
    (`renders`, `lpips`, `losses`, `backward`, `adam`), each LPIPS call
    a span `lpips_chunk` inside `lpips`, counted by the counters
    `lpips_chunks` and `lpips_chunk_images`; a step called with a `mark`
    turns the recorder on for the rest of the process, since its caller
    traces it.
    `lpips_fn(img1, img2)` -> (b,) distances of (b, 3, h, w) images.
    `train_step.loss_fn` is the loss alone, of this rank's jobs under a
    `mesh` (the batch is then this rank's share, see the module
    docstring)."""
    if stage not in ("s1", "s2"):
        raise ValueError(f"stage must be 's1' or 's2', got {stage!r}")
    B = n_motions * n_views * n_frames
    per = n_views * n_frames
    rows = mesh.rows(B) if mesh is not None else slice(0, B)
    first, n_loc = rows.start, rows.stop - rows.start
    lead = mesh is None or mesh.rank == 0     # adds the parameter-only terms
    # this rank's jobs of each motion: (motion slot, local lo, hi, share)
    chunks = [(m, lo - first, hi - first, (hi - lo) / per)
              for m in range(n_motions)
              for lo, hi in [(max(m * per, first),
                              min((m + 1) * per, rows.stop))] if hi > lo]
    # LPIPS's calls: runs of consecutive `chunks` entries of at most
    # LPIPS_PIXELS pixels together (an entry over it is a call alone)
    cap = max(1, LPIPS_PIXELS // (width * height))
    lpips_calls = []
    for c in chunks:
        if lpips_calls and c[2] - lpips_calls[-1][0][1] <= cap:
            lpips_calls[-1].append(c)
        else:
            lpips_calls.append([c])

    def by_motion(vals):
        """(n_motions,) of one value per entry of `chunks`; 0 for a motion
        with no job here."""
        if len(chunks) == n_motions:
            return torch.stack(vals)
        out = [torch.zeros((), device=vals[0].device)] * n_motions
        for (m, *_), v in zip(chunks, vals):
            out[m] = v
        return torch.stack(out)

    def motion_terms(fn, *xs):
        """(n_motions,) of fn over each motion's local images times their
        share of the motion; 0 for a motion with no job here."""
        return by_motion([fn(*(x[lo:hi] for x in xs)) * share
                          for _, lo, hi, share in chunks])

    def lpips_by_motion(imgs, gt):
        """The LPIPS terms, (n_motions,) as `motion_terms` gives them but
        detached, and `lambda_lpips` times their gradient with respect to
        `imgs`, one call of `lpips_calls` at a time: its VGG forward and
        input VJP together on the detached renders, so that one call's
        activations are held at a time."""
        grad = torch.empty_like(imgs)
        vals = []
        with lpips_mod.shared_constants():
            for call in lpips_calls:
                lo, hi = call[0][1], call[-1][2]
                with diagnostics.span("lpips_chunk"):
                    diagnostics.RECORDER.count("lpips_chunks")
                    diagnostics.RECORDER.count("lpips_chunk_images", hi - lo)
                    x = imgs[lo:hi].detach().requires_grad_()
                    with torch.enable_grad():
                        d = lpips_fn(x, gt[lo:hi])
                        v = [torch.mean(d[a - lo:b - lo]) * share
                             for _, a, b, share in call]
                        (g,) = torch.autograd.grad(
                            lcfg.lambda_lpips * sum(v), x)
                    grad[lo:hi] = g
                    vals += [t.detach() for t in v]
        return by_motion(vals), grad

    def skip_vae_noise(params, generator, n):
        """Draw and drop the VAE noise of n jobs rendered by other ranks."""
        mu = params.latent["mu"][0]
        for _ in range(n):
            torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                        device=generator.device)

    def loss_fn(params, aux, batch, step: int, arap_times=None,
                generator: torch.Generator | None = None, mark=None,
                tap: torch.Tensor | None = None):
        """tap: the `mean2d_tap` (N, 2) of the LAST render of the batch."""
        dev = params.xyz.device
        bg = torch.ones(3, device=dev)
        knn_cache = find_knn(params, aux) if stage >= "s2" else None
        times = torch.as_tensor(batch["times"]).tolist()
        lidx = [int(i) for i in torch.as_tensor(batch["latent_idx"]).tolist()]
        if len(lidx) != n_loc:
            raise ValueError(f"a batch of {len(lidx)} jobs where this rank "
                             f"renders {n_loc} of {B}")
        vae_rng = generator if lcfg.vae else None
        if vae_rng is not None:
            skip_vae_noise(params, vae_rng, first)
        outs = render(
            cfg, params, aux, [batch["camera"][i] for i in range(n_loc)],
            times, stage, lidx, width, height, bg, rng=vae_rng,
            knn_cache=knn_cache, capacity=capacity,
            mean2d_tap=tap if rows.stop == B else None)
        if vae_rng is not None:
            skip_vae_noise(params, vae_rng, B - rows.stop)
        diagnostics.RECORDER.cut("renders", mark)
        imgs = outs["image"]                                  # (B, 3, h, w)
        masks = outs["alpha"]

        gt_img = torch.as_tensor(batch["gt_image"], device=dev)
        gt_msk = torch.as_tensor(batch["gt_mask"], device=dev)
        gt = (gt_img.to(torch.float32) / 255.0).permute(0, 3, 1, 2)
        if tuple(gt.shape[2:]) != (height, width):
            gt = resize_linear(gt, height, width)
        gt_m = (gt_msk.to(torch.float32) / 255.0)[:, None]
        if tuple(gt_m.shape[2:]) != (height, width):
            gt_m = resize_linear(gt_m, height, width)
        if lpips_fn is not None:
            lp, lp_grad = lpips_by_motion(imgs, gt)
            diagnostics.RECORDER.cut("lpips", mark)
        else:
            lp = torch.zeros((n_motions,), device=dev)

        per_img_mse = torch.mean((imgs - gt) ** 2, dim=(1, 2, 3))   # (B,)
        with diagnostics.host_wait("mse_w"):
            mse_w = torch.as_tensor(batch["mse_w"], dtype=torch.float32,
                                    device=dev)
        loss = lcfg.lambda_mse * torch.sum(mse_w * per_img_mse)

        nhwc = lambda x: x.permute(0, 2, 3, 1)               # noqa: E731
        ssim_losses = motion_terms(lambda a, b: 1.0 - L.ssim(a, b),
                                   nhwc(imgs), nhwc(gt))
        loss = loss + lcfg.lambda_ssim * torch.sum(ssim_losses)
        if lpips_fn is not None:
            loss = (loss + lcfg.lambda_lpips * torch.sum(lp)
                    + _InputGrad.apply(imgs, lp_grad))
        mask_losses = motion_terms(lambda a, b: torch.mean((a - b) ** 2),
                                   masks, gt_m)
        loss = loss + lcfg.lambda_mask * torch.sum(mask_losses)

        lidx_all = [int(i) for i in torch.as_tensor(
            batch.get("latent_idx_all", lidx)).tolist()]
        m_idx = lidx_all[::per]
        kl = torch.zeros((), device=dev)
        if lcfg.vae:
            mu = params.latent["mu"][m_idx]
            log_var = params.latent["log_var"][m_idx]
            kl = torch.sum(-0.5 * torch.sum(
                1 + log_var - mu ** 2 - torch.exp(log_var), dim=-1))
            if lead:
                loss = loss + lcfg.lambda_kl * kl

        i_nhwc = nhwc(imgs)
        smooth_l = torch.zeros((), device=dev)
        if lcfg.add_depth:
            smooth_l = torch.sum(motion_terms(
                L.edge_aware_smoothness, nhwc(outs["depth"]), i_nhwc))
            gate = float(step > lcfg.depth_reg_start_iter)
            loss = loss + gate * lcfg.lambda_smooth * smooth_l
        bilat_l = torch.zeros((), device=dev)
        if lcfg.add_normal:
            bilat_l = torch.sum(motion_terms(
                L.bilateral_normal_smoothness, nhwc(outs["normal"]), i_nhwc))
            gate = float(step > lcfg.normal_reg_start_iter)
            loss = loss + gate * lcfg.lambda_bilateral * bilat_l

        arap_l = torch.zeros((), device=dev)
        if lcfg.use_arap and trainable_groups is None:
            if stage == "s1":
                gate = float(step > lcfg.arap_start_iter_s1)
                base, node_valid = params.xyz, aux.active
            else:
                gate = float(step < lcfg.arap_end_iter_s2)
                base, node_valid = params.c_xyz, aux.c_active
            if arap_times is None:
                arap_times = torch.rand((lcfg.arap_t_samples,),
                                        generator=generator)
            with diagnostics.host_wait("arap_times"):
                q = torch.as_tensor(arap_times, dtype=torch.float32,
                                    device=dev)[:, None, None]
            pts = base[None].expand(q.shape[0], *base.shape)
            for li in m_idx:
                lat = G.sample_latent(params, li, None)
                d_xyz_t, _ = params.timenet(pts, q, lat)       # (T, M, 3)
                arap_l = arap_l + arap_mod.arap_loss(
                    base, d_xyz_t, valid=node_valid,
                    radius=lcfg.arap_radius, generator=generator)
            if lead:
                loss = loss + gate * lcfg.lambda_arap * arap_l

        ga_l = torch.zeros((), device=dev)
        if use_guidance and stage >= "s2" and lcfg.add_ga:
            c_valid = aux.c_active
            guid = torch.as_tensor(batch["guidance"], device=dev).detach()
            for c, g in zip(outs["cpts_t"], guid):
                if lcfg.ga_chamfer:
                    ga_l = ga_l + neighbors.chamfer_forward(c, g,
                                                            x_valid=c_valid)
                else:
                    diff = torch.where(c_valid[:, None], gc.abs(c - g),
                                       torch.zeros_like(c))
                    ga_l = ga_l + torch.sum(diff) / torch.clamp_min(
                        torch.sum(c_valid) * 3.0, 1.0)
            lam = lcfg.lambda_ga1 if lcfg.ga_chamfer else lcfg.lambda_ga2
            loss = loss + lam * ga_l

        metrics = {
            "loss": loss, "mse": torch.mean(per_img_mse),
            "ssim_loss": ssim_losses, "lpips": lp,
            "mask_loss": mask_losses, "kl": kl, "arap": arap_l,
            "ga": ga_l, "smooth": smooth_l, "bilateral": bilat_l,
            "overflow": torch.sum(outs["overflow"]),
            "overflow_max": torch.max(outs["overflow_max"]),
        }
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            metrics = whole_batch_metrics(metrics)
        for k in ("ssim_loss", "lpips", "mask_loss"):
            metrics[k] = torch.mean(metrics[k])
        metrics["psnr"] = L.psnr(metrics["mse"])
        vis_aux = {"radii": outs["radii"][-1].detach(),
                   "visibility": outs["visibility_filter"][-1],
                   "debug_render": imgs[0].detach(), "debug_gt": gt[0]}
        diagnostics.RECORDER.cut("losses", mark)
        return loss, (metrics, vis_aux)

    def whole_batch_metrics(m: dict) -> dict:
        """The metrics of the whole batch from each rank's: sums over
        ranks (the per-motion vectors too, whose entries add up a motion
        that straddles ranks), the mean MSE over all B images, the maximum
        strip overflow; KL and ARAP are the same on every rank."""
        summed = ("loss", "ssim_loss", "lpips", "mask_loss", "ga", "smooth",
                  "bilateral", "overflow")
        parts = [m["mse"] * (n_loc / B)] + [m[k] for k in summed]
        flat = mesh_mod.all_reduce_(torch.cat(
            [p.reshape(-1).to(torch.float64) for p in parts]), mesh)
        out = dict(m)
        off = 0
        for k, p in zip(("mse",) + summed, parts):
            out[k] = flat[off:off + p.numel()].view(p.shape).to(p.dtype)
            off += p.numel()
        out["overflow_max"] = mesh_mod.all_reduce_(
            m["overflow_max"].clone(), mesh, op="max")
        return out

    def train_step(state: TrainState, batch: dict, arap_times=None,
                   mark=None):
        if mark is not None:
            diagnostics.RECORDER.start()    # the caller traces the step
        diagnostics.RECORDER.cut(None)
        step = state.step + 1
        leaves = optim.named_leaves(state.params)
        for leaf in leaves.values():
            leaf.grad = None
        tap = None
        if stage == "s1":
            tap = torch.zeros((state.params.xyz.shape[0], 2),
                              device=state.params.xyz.device,
                              requires_grad=True)
        loss, (metrics, vis_aux) = loss_fn(state.params, state.aux, batch,
                                           step, arap_times, state.rng, mark,
                                           tap)
        loss.backward()
        diagnostics.RECORDER.cut("backward", mark)
        with torch.no_grad():
            grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                     for k, v in leaves.items()}
            if mesh is not None:
                # the whole batch's gradient on every rank, before the guard
                mesh_mod.sum_flat_(list(grads.values()), mesh)
            # one inf/nan leaf, or |g| so large that g*g overflows the
            # second moment, would poison Adam for good: such a step is
            # skipped (the reference's guard, taken before clipping)
            gl = [g for g in grads.values() if g.numel()]
            sup_g = torch.max(torch.stack([g.abs().amax() for g in gl]))
            finite = torch.stack([torch.isfinite(g).all() for g in gl]).all()
            grads_ok = finite & (sup_g < 1e17)
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in gl))
            if lcfg.grad_clip_norm > 0:
                scale = torch.clamp_max(lcfg.grad_clip_norm / (gnorm + 1e-12),
                                        1.0)
                grads = {k: g * scale for k, g in grads.items()}
            zero = torch.zeros((), device=sup_g.device)
            grads = {k: torch.where(grads_ok, g, zero) for k, g in grads.items()}
            lr_g = group_lrs(lcfg, step, stage, trainable_groups)
            lrs = {k: lr_g[optim.leaf_group(k)] for k in leaves}
            new, new_opt = optim.update(leaves, grads, state.opt, lrs)
            for k, p in leaves.items():
                p.copy_(torch.where(grads_ok, new[k], p))
            old = state.opt
            state.opt = optim.AdamState(
                mu={k: torch.where(grads_ok, new_opt.mu[k], old.mu[k])
                    for k in leaves},
                nu={k: torch.where(grads_ok, new_opt.nu[k], old.nu[k])
                    for k in leaves},
                step=torch.where(grads_ok, new_opt.step, old.step))
            for leaf in leaves.values():
                leaf.grad = None
            # densification statistics from the LAST render of the batch,
            # inside the window the densifier reads them in; not gated by
            # grads_ok (the reference's behaviour)
            if stage == "s1" and (
                    step % lcfg.fps_iter >= lcfg.density_start_iter
                    and step <= lcfg.density_end_iter):
                gtap = tap.grad if tap.grad is not None \
                    else torch.zeros_like(tap)
                radii, vis = vis_aux["radii"], vis_aux["visibility"]
                if mesh is not None:
                    # the batch's last render lives on the last rank
                    vis = vis.clone()
                    mesh_mod.replicate((gtap, radii, vis), mesh,
                                       src=mesh.size - 1)
                upd = G.update_max_radii(state.aux, radii, vis)
                state.aux = G.add_densification_stats(upd, gtap, vis)
        state.step = step
        diagnostics.RECORDER.cut("adam", mark, last=True)
        metrics = dict(metrics)
        metrics["nonfinite_grad"] = (~grads_ok).to(torch.int32)
        metrics["grad_norm"] = gnorm
        metrics["grad_sup"] = sup_g
        metrics["debug_render"] = vis_aux["debug_render"]
        metrics["debug_gt"] = vis_aux["debug_gt"]
        return state, metrics

    train_step.loss_fn = loss_fn
    return train_step
