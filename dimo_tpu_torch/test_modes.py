"""Inference/test entry points: the reference's six test modes + FPS harness.

Counterpart of `dimo_tpu/test_modes.py`, with the same functions, file
names and mode routing (`cli.py::run_test`):
  * default test       — per-motion 4D renders + control point trajectories
  * test_cpts          — key-point-only renders with trajectory overlays
  * test_interpolation — average two latents, render the blend
  * test_language      — text -> BERT -> MLP projector -> latent -> render
  * test_motion        — fit a fresh latent to an unseen motion (1000 steps)
  * test_unaligned_motion — two-phase latent+deformnet finetune
  * test_paper         — selected-motion renders (fixed + diagonal orbit)
  * test_fps           — render-throughput benchmark

Every render runs on the trainer's device under `torch.no_grad()`; frames
come back to the host as uint8 and go out through `viz.py`'s writers. At
stage s2 the KNN of the Gaussians among the control points is computed
once per sequence (`render_sequence`, `run_test_fps`); the reference
recomputes it inside every render of a sequence from the same parameters,
which gives the same values.

Where the port differs, by PyTorch's idiom: the fine-tuning modes build a
fresh `TrainState` with `train/step.py::init_state` and update its leaves
in place; a fresh latent code is drawn from a `torch.Generator` seeded
seed + 123 (seed + 321 for the control-point phase), so its numbers are
not those of the reference's `jax.random.normal` (`_fresh_codes`).
`run_test_fps` with `spatial_parallel=N` shards each frame's compositing
over a group of N ranks (`torchrun`; `parallel/mesh.py`).
"""
from __future__ import annotations

import copy
import dataclasses
import os
import time

import numpy as np
import torch

from dimo_tpu_torch import viz
from dimo_tpu_torch.models import gaussians as G
from dimo_tpu_torch.models.renderer import find_knn, render

LATENT_GROUPS = frozenset({"latent_code", "latent_code_mu",
                           "latent_code_log_var"})


# ---------------------------------------------------------------------------
# rendering helpers

def _render_fn(tr, stage, width, height):
    """A (params, aux, cam, t, latent_index, knn_cache) -> outputs fn at
    the run's capacity and a white background (the reference's
    `_jit_render`)."""
    cfg = tr.mcfg
    bg = torch.ones(3, device=tr.device)
    capacity = int(tr.opt.get("tile_capacity", 512))

    @torch.no_grad()
    def fn(params, aux, cam, t, li, knn_cache=None):
        return render(cfg, params, aux, cam, t, stage, li, width, height, bg,
                      knn_cache=knn_cache, capacity=capacity)
    return fn


def _to_u8(img_chw: torch.Tensor) -> np.ndarray:
    return (img_chw.detach().cpu().numpy().transpose(1, 2, 0).clip(0, 1)
            * 255).astype(np.uint8)


def render_sequence(tr, latent_index: int, stage: str, render_type: str = "fixed",
                    render_fn=None):
    """num_frames-frame sequence from the fixed or per-frame-orbit camera."""
    opt = tr.opt
    W, H = int(opt.W), int(opt.H)
    fn = render_fn or _render_fn(tr, stage, W, H)
    params, aux = tr.state.params, tr.state.aux
    knn = find_knn(params, aux) if stage >= "s2" else None
    frames = []
    for i in range(tr.num_frames):
        azi = opt.test_azi if render_type == "fixed" \
            else 360 / tr.num_frames * i
        cam = tr.camera_for(azi)
        out = fn(params, aux, cam, i / tr.num_frames, latent_index, knn)
        frames.append(_to_u8(out["image"]))
    return frames


def cpt_model(tr):
    """Temp model whose Gaussians ARE the control points (reference test_cpts
    scaffold, `main_train_dimo.py:620-640`): scale e^-5, opacity sigma(2),
    flat gray color. Shares the trainer's latent and TimeNet."""
    p = tr.state.params
    aux = tr.state.aux
    if tr.stage >= "s2" or bool(aux.c_active.any()):
        base, act = p.c_xyz, aux.c_active
    else:
        base, act = p.xyz, aux.active
    n = base.shape[0]
    cfg2 = G.ModelConfig(sh_degree=0, latent_dim=tr.mcfg.latent_dim,
                         num_latents=tr.mcfg.num_latents, vae=tr.mcfg.vae,
                         capacity=n, cpt_capacity=n)
    params2, aux2 = G._blank(cfg2, tr.device)
    with torch.no_grad():
        params2.xyz.copy_(base)
        params2.scaling.fill_(-5.0)
        params2.opacity.fill_(2.0)
        params2.r.fill_(-5.0)
    params2 = params2.replace(latent=p.latent, timenet=p.timenet)
    aux2 = aux2.replace(active=act.clone(), c_active=act.clone())
    return cfg2, params2, aux2, act


def test_cpts(tr, test_stage: str = "s2", render_type: str = "fixed",
              latent_index: int = 0, motion_video_name: str = "motion",
              make_3d: bool = True):
    """Key-point renders + trajectory overlays. Returns
    (frames, traj_imgs, traj_imgs_3d, traj_pts_2d)."""
    opt = tr.opt
    W, H = int(opt.W), int(opt.H)
    video_save_dir = opt.video_save_dir
    os.makedirs(video_save_dir, exist_ok=True)

    cfg2, params2, aux2, act = cpt_model(tr)
    bg = torch.ones(3, device=tr.device)
    capacity = int(opt.get("tile_capacity", 512))
    color = torch.full((3,), 0.1, dtype=torch.float32, device=tr.device)

    frames, traj_pts, traj_pts_3d = [], [], []
    act_np = act.cpu().numpy()
    with torch.no_grad():
        for i in range(tr.num_frames):
            azi = opt.test_azi if render_type == "fixed" \
                else 360 / tr.num_frames * i
            cam = tr.camera_for(azi)
            out = render(cfg2, params2, aux2, cam, i / tr.num_frames, "s1",
                         latent_index, W, H, bg, override_color=color,
                         capacity=capacity)
            frames.append(_to_u8(out["image"]))
            cpts_t = out["cpts_t"].cpu().numpy()[act_np]
            traj_pts_3d.append(cpts_t)
            traj_pts.append(viz.project_points(cpts_t, cam.full_proj, W, H))

    save_name = os.path.basename(str(opt.save_path) or "run").split(".")[0]
    suffix = opt.test_azi if render_type == "fixed" else "circle"
    viz.write_video(os.path.join(
        video_save_dir, f"{save_name}_{motion_video_name}_cpts_{suffix}.mp4"),
        frames)

    traj_pts = np.stack(traj_pts, axis=1)          # (N, F, 2)
    traj_imgs, traj_imgs_3d = [], []
    if render_type == "fixed":
        traj_img, alpha_img = viz.trajectory_image(traj_pts, W, H)
        comp = np.concatenate([traj_img, alpha_img[..., :1]], -1) * 255
        from PIL import Image
        Image.fromarray(comp.astype(np.uint8)).save(os.path.join(
            video_save_dir, f"trajectory_{motion_video_name}.png"))
        traj_imgs = viz.trajectory_frames(traj_pts, W, H)
        if make_3d:
            tracks = np.stack(traj_pts_3d, axis=0)  # (F, N, 3)
            vid3d = viz.plot_3d_tracks(tracks, tracks_leave_trace=8)
            traj_imgs_3d = [vid3d]
            viz.write_video(os.path.join(
                video_save_dir, f"trajectory_3d_{motion_video_name}.mp4"), vid3d)
            with open(os.path.join(
                    video_save_dir,
                    f"trajectory_3d_{motion_video_name}.html"), "w") as f:
                f.write(viz.interactive_3d_html(tracks))
    return frames, traj_imgs, traj_imgs_3d, traj_pts


def run_default_test(tr, render_type: str = "fixed", do_cpts: bool = True):
    """Reference default test (`main_test_dimo.py:199-365`): per-motion 4D
    renders + cpt trajectories, then all-in-one grid-mosaic videos."""
    opt = tr.opt
    tr.load_checkpoint(opt.test_stage, step=opt.get("test_step"))
    os.makedirs(opt.video_save_dir, exist_ok=True)
    stage = opt.test_stage
    render_fn = _render_fn(tr, stage, int(opt.W), int(opt.H))
    save_name = os.path.basename(str(opt.save_path) or "run").split(".")[0]

    all_imgs, all_traj, all_traj_3d = [], [], []
    for vi, name in enumerate(tr.input_videos):
        if do_cpts:
            _, traj_imgs, traj_imgs_3d, _ = test_cpts(
                tr, test_stage=stage, render_type=render_type,
                latent_index=vi, motion_video_name=name)
            if traj_imgs:
                all_traj.append(np.stack(traj_imgs))
            if traj_imgs_3d:
                all_traj_3d.append(np.stack(traj_imgs_3d).squeeze(0))
        frames = render_sequence(tr, vi, stage, render_type, render_fn)
        all_imgs.append(np.stack(frames))
        kind = "fixed" if render_type == "fixed" else "circle"
        viz.write_video(os.path.join(
            opt.video_save_dir, f"{save_name}_{name}_{stage}_{kind}.mp4"),
            frames)

    # all-in-one grid mosaics (reference `main_test_dimo.py:344-365`; written
    # into video_save_dir instead of cwd)
    _write_mosaic(opt.video_save_dir, "all_render_imgs.mp4", all_imgs)
    if do_cpts:
        _write_mosaic(opt.video_save_dir, "all_traj_imgs.mp4", all_traj)
        _write_mosaic(opt.video_save_dir, "all_traj_imgs_3d.mp4", all_traj_3d)
    return all_imgs


def _write_mosaic(video_save_dir: str, fname: str, clips: list):
    """Tile per-motion (F, H, W, C) clips into an n_rows x rows_len grid video
    (reference mosaic layout, `main_test_dimo.py:345-351`)."""
    import math
    if not clips:
        return
    n_rows = max(1, math.floor(math.sqrt(len(clips))))
    rows_len = len(clips) // n_rows
    if rows_len == 0:
        return
    rows = []
    for r in range(n_rows):
        row = np.concatenate(clips[r * rows_len:(r + 1) * rows_len], axis=2)
        rows.append(row[..., :3])
    grid = np.concatenate(rows, axis=1)
    viz.write_video(os.path.join(video_save_dir, fname), list(grid))


def _set_latent(tr, latent: dict) -> None:
    """Replace the trainer's latent dict (its Adam moments are left as
    they are, as the reference's `state.replace(params=...)` does)."""
    tr.state = dataclasses.replace(
        tr.state, params=tr.state.params.replace(latent=latent))


def run_test_interpolation(tr, name1: str | None = None, name2: str | None = None,
                           render_type: str = "fixed"):
    """Average two motions' latents and render (`main_test_dimo.py:504-573`).
    Motion names default to the reference's pair when present, else the
    first and last motions. Every latent row is set to the mix."""
    opt = tr.opt
    tr.load_checkpoint(opt.test_stage, step=opt.get("test_step"))
    vids = tr.input_videos
    name1 = name1 or ("04-032041" if "04-032041" in vids else vids[0])
    name2 = name2 or ("11-raise" if "11-raise" in vids else vids[-1])
    i1, i2 = vids.index(name1), vids.index(name2)

    lat = tr.state.params.latent
    with torch.no_grad():
        if "codes" in lat:
            mixed = (lat["codes"][i1] + lat["codes"][i2]) / 2
            latent = {"codes": mixed[None].repeat(len(vids), 1)}
        else:
            mu = (lat["mu"][i1] + lat["mu"][i2]) / 2
            lv = (lat["log_var"][i1] + lat["log_var"][i2]) / 2
            latent = {"mu": mu[None].repeat(len(vids), 1),
                      "log_var": lv[None].repeat(len(vids), 1)}
    _set_latent(tr, latent)

    motion_name = f"intp_{name1}_{name2}"
    frames, traj_imgs, _, _ = test_cpts(
        tr, test_stage=opt.test_stage, render_type=render_type,
        latent_index=0, motion_video_name=motion_name)
    seq = render_sequence(tr, 0, opt.test_stage, render_type)
    viz.write_video(os.path.join(opt.video_save_dir, f"{motion_name}.mp4"), seq)
    _write_blend(opt.video_save_dir, motion_name, seq, traj_imgs)
    return seq


def _write_blend(video_save_dir, name, frames, traj_imgs):
    import cv2
    blended = []
    for ti, traj in enumerate(traj_imgs[:len(frames)]):
        gray = cv2.cvtColor(frames[ti], cv2.COLOR_RGB2GRAY)[..., None]
        mask = (traj.astype(np.float32).sum(-1, keepdims=True) > 0).astype(
            np.float32)
        img = gray * (1 - mask) + traj[..., :3] * mask
        blended.append(img.astype(np.uint8))
    if blended:
        viz.write_video(os.path.join(video_save_dir, f"{name}_blend.mp4"),
                        blended)


def run_test_language(tr, text_prompt: str, render_type: str = "fixed",
                      text_emb: np.ndarray | None = None,
                      mlp_weights: str | None = None):
    """Text -> latent -> render (`main_test_dimo.py:576-642`).

    text_emb: optional precomputed 768-d BERT pooled embedding (for
    environments without the bert-base-cased weights cached)."""
    from dimo_tpu_torch.models.text import get_motion_embs, load_mlp_projector

    opt = tr.opt
    tr.load_checkpoint(opt.test_stage, step=opt.get("test_step"))
    if text_emb is None:
        text_emb = get_motion_embs([text_prompt])[0]
    proj = load_mlp_projector(
        mlp_weights or os.path.join(str(opt.save_path), "mlp_encoder.pth"),
        latent_dim=tr.mcfg.latent_dim, device=tr.device)
    with torch.no_grad():
        latent_code = proj(torch.as_tensor(
            np.asarray(text_emb, np.float32), device=tr.device))
    if "codes" in tr.state.params.latent:
        latent = {"codes": latent_code[None]}
    else:
        latent = {"mu": latent_code[None],
                  "log_var": torch.full((1, latent_code.shape[-1]), -20.0,
                                        dtype=torch.float32, device=tr.device)}
    _set_latent(tr, latent)

    frames, traj_imgs, _, _ = test_cpts(
        tr, test_stage=opt.test_stage, render_type=render_type,
        latent_index=0, motion_video_name=text_prompt)
    seq = render_sequence(tr, 0, opt.test_stage, render_type)
    viz.write_video(os.path.join(opt.video_save_dir, f"{text_prompt}.mp4"), seq)
    _write_blend(opt.video_save_dir, text_prompt, seq, traj_imgs)
    return seq


# ---------------------------------------------------------------------------
# test-time fine-tuning

def _device_batch_sampler(tr, images: np.ndarray, masks: np.ndarray,
                          n_guid: int):
    """Per-iter finetune batch assembly with the frames resident on device.

    The motion's (V, F) frames are uploaded ONCE and the sampled rows
    gathered on the device each iteration; cameras are cached per view and
    the constant fields per batch size. The batch carries a list of
    cameras (`train/step.py`'s layout)."""
    num_views, num_frames = images.shape[0], images.shape[1]
    dev = tr.device
    dev_imgs = torch.from_numpy(np.ascontiguousarray(
        images.reshape((-1,) + images.shape[2:]))).to(dev)
    dev_msks = torch.from_numpy(np.ascontiguousarray(
        masks.reshape((-1,) + masks.shape[2:]))).to(dev)
    cams_by_view = [tr.camera_for(tr.azimuths[v]) for v in range(num_views)]
    const_cache = {}

    def assemble(views, frames):
        flat = torch.tensor([v * num_frames + f for v in views for f in frames],
                            dtype=torch.long, device=dev)
        cams = [cams_by_view[v] for v in views for _ in frames]
        times = np.asarray([f / num_frames for _ in views for f in frames],
                           np.float32)
        b = len(views) * len(frames)
        if b not in const_cache:
            const_cache[b] = (np.zeros((b,), np.int32),
                              np.ones((b,), np.float32),
                              torch.zeros((b, n_guid, 3), device=dev))
        li, w, guid = const_cache[b]
        return {
            "camera": cams,
            "times": times,
            "latent_idx": li,
            "mse_w": w,
            "gt_image": dev_imgs[flat],
            "gt_mask": dev_msks[flat],
            "guidance": guid,
        }

    return assemble


def _fresh_codes(seed: int, latent_dim: int, device) -> torch.Tensor:
    """(1, latent_dim) standard normal latent code for a fit, from a
    `torch.Generator` seeded `seed` (the reference draws
    `jax.random.normal(PRNGKey(seed))`: other numbers, same law)."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((1, latent_dim), generator=gen).to(device)


def _fresh_latent(tr, seed: int, like: dict) -> dict:
    """A one-row latent dict of `like`'s kind: a drawn code, or zero mu and
    log_var in VAE mode."""
    dim = tr.mcfg.latent_dim
    if "codes" in like:
        return {"codes": _fresh_codes(seed, dim, tr.device)}
    return {"mu": torch.zeros((1, dim), device=tr.device),
            "log_var": torch.zeros((1, dim), device=tr.device)}


def _sample_views_frames(rng, bs: int, num_views: int, num_frames: int):
    """Views [0] + bs others and bs frames, drawn from `rng` in the
    reference's order."""
    views = [0] + rng.sample(range(1, num_views), min(bs, num_views - 1))
    frames = rng.sample(range(num_frames), min(bs, num_frames))
    return views, frames


def finetune_latent_to_motion(tr, images: np.ndarray, masks: np.ndarray,
                              iters: int = 1000, trainable=LATENT_GROUPS,
                              fresh_latent: bool = True,
                              lpips_fn=None, log_fn=None):
    """Fit a fresh latent to an unseen motion (reference test_motion /
    finetune_latent, `main_test_dimo.py:645-777,909-1009`).

    images: (V, F, S, S, 3) u8; masks: (V, F, S, S) u8 for ONE motion.
    Sets tr.state.params.latent to a single fitted code (the other leaves
    train only if `trainable` names their groups). lpips_fn: perceptual
    loss active during finetuning like the reference
    (`main_test_dimo.py:979`); log_fn(it, metrics) receives the
    PSNR/SSIM/LPIPS scalars the reference writes to TensorBoard
    (`:972-990`). Resolution 128 / 256 / 512 at it < 100 / < 200 / after.
    """
    from dimo_tpu_torch.train.loop import loss_config_from_opt
    from dimo_tpu_torch.train.step import init_state, make_train_step

    opt = tr.opt
    p = tr.state.params
    seed = int(opt.seed or 0) + 123
    if fresh_latent:
        latent = _fresh_latent(tr, seed, p.latent)
    else:
        latent = {k: v.detach()[:1].clone() for k, v in p.latent.items()}
    state = init_state(p.replace(latent=latent), tr.state.aux, step=0,
                       seed=seed)

    bs = int(opt.batch_size)
    num_views, num_frames = images.shape[0], images.shape[1]
    lcfg = loss_config_from_opt(opt, "s2")
    assemble = _device_batch_sampler(tr, images, masks, p.c_xyz.shape[0])
    step_fns = {}
    for it in range(1, iters + 1):
        res = 128 if it < 100 else (256 if it < 200 else 512)
        views, frames = _sample_views_frames(tr.py_rng, bs, num_views,
                                             num_frames)
        batch = assemble(views, frames)
        shape_key = (res, len(views), len(frames))
        if shape_key not in step_fns:
            step_fns[shape_key] = make_train_step(
                tr.mcfg, lcfg, "s2", res, res, 1, len(views), len(frames),
                capacity=int(opt.get("tile_capacity", 512)),
                lpips_fn=lpips_fn, trainable_groups=trainable)
        state, metrics = step_fns[shape_key](state, batch)
        if log_fn is not None:
            log_fn(it, metrics)
        if it % 100 == 0:
            print(f"[finetune {it}] loss={float(metrics['loss']):.4f} "
                  f"psnr={float(metrics['psnr']):.2f} "
                  f"ssim_loss={float(metrics['ssim_loss']):.4f} "
                  f"lpips={float(metrics['lpips']):.4f}")
    tr.state = dataclasses.replace(tr.state, params=state.params)
    return metrics


def run_test_motion(tr, motion_images, motion_masks, iters: int = 1000,
                    lpips_fn=None, log_fn=None):
    """Full test_motion flow: finetune latent, then render outputs."""
    opt = tr.opt
    tr.load_checkpoint(opt.test_stage, step=opt.get("test_step"))
    metrics = finetune_latent_to_motion(tr, motion_images, motion_masks, iters,
                                        lpips_fn=lpips_fn, log_fn=log_fn)
    os.makedirs(opt.video_save_dir, exist_ok=True)
    frames, traj_imgs, _, _ = test_cpts(tr, test_stage=opt.test_stage,
                                        latent_index=0,
                                        motion_video_name="test_motion")
    seq = render_sequence(tr, 0, opt.test_stage, "fixed")
    viz.write_video(os.path.join(opt.video_save_dir, "render_images.mp4"), seq)
    diag = render_sequence(tr, 0, opt.test_stage, "circle")
    viz.write_video(os.path.join(opt.video_save_dir, "render_images_diag.mp4"),
                    diag)
    _write_blend(opt.video_save_dir, "blend", seq, traj_imgs)
    return metrics


def _finetune_cpt_only(tr, images, masks, iters, trainable):
    """Phase-A finetune on a control-point-only model (reference
    `main_test_dimo.py:1029-1034`: cheap latent+deformnet alignment by
    rendering just the key-point blobs), with the s1 loss config at 128^2
    then 256^2 and no LPIPS. The trained latent/TimeNet are grafted back
    into the full model; until then the trainer's TimeNet is untouched
    (phase A trains a copy)."""
    from dimo_tpu_torch.train.loop import loss_config_from_opt
    from dimo_tpu_torch.train.step import init_state, make_train_step

    opt = tr.opt
    cfg2, params2, aux2, _ = cpt_model(tr)
    seed = int(opt.seed or 0) + 321
    params2 = params2.replace(latent=_fresh_latent(tr, seed, params2.latent),
                              timenet=copy.deepcopy(params2.timenet))
    state = init_state(params2, aux2, step=0, seed=seed)

    bs = int(opt.batch_size)
    num_views, num_frames = images.shape[0], images.shape[1]
    lcfg = loss_config_from_opt(opt, "s1")
    assemble = _device_batch_sampler(tr, images, masks,
                                     params2.c_xyz.shape[0])
    step_fns = {}
    for it in range(1, iters + 1):
        res = 128 if it < 100 else 256
        views, frames = _sample_views_frames(tr.py_rng, bs, num_views,
                                             num_frames)
        batch = assemble(views, frames)
        shape_key = (res, len(views), len(frames))
        if shape_key not in step_fns:
            step_fns[shape_key] = make_train_step(
                cfg2, lcfg, "s1", res, res, 1, len(views), len(frames),
                capacity=int(opt.get("tile_capacity", 512)),
                trainable_groups=trainable)
        state, metrics = step_fns[shape_key](state, batch)
    # graft the aligned latent + deformnet back into the full model
    tr.state = dataclasses.replace(tr.state, params=tr.state.params.replace(
        latent=state.params.latent, timenet=state.params.timenet))
    return metrics


def run_test_unaligned_motion(tr, motion_images, motion_masks,
                              iters_a: int = 400, iters_b: int = 1000,
                              lpips_fn=None, log_fn=None):
    """Two-phase finetune for unaligned motions
    (`main_test_dimo.py:1012-1320`): phase A fits latent+deformnet on the
    control-point-only renderer, phase B refines them jointly on the full
    model."""
    opt = tr.opt
    tr.load_checkpoint(opt.test_stage, step=opt.get("test_step"))
    groups = LATENT_GROUPS | {"deform", "deform_rot"}
    _finetune_cpt_only(tr, motion_images, motion_masks, iters_a,
                       trainable=groups)
    metrics = finetune_latent_to_motion(
        tr, motion_images, motion_masks, iters_b, trainable=groups,
        fresh_latent=False, lpips_fn=lpips_fn, log_fn=log_fn)
    seq = render_sequence(tr, 0, opt.test_stage, "fixed")
    os.makedirs(opt.video_save_dir, exist_ok=True)
    viz.write_video(os.path.join(opt.video_save_dir,
                                 "render_images_unaligned.mp4"), seq)
    return metrics


# ---------------------------------------------------------------------------
# paper figures and the FPS harness

def run_test_paper(tr, motions: list[str] | None = None):
    """Selected-motion fixed + diagonal-orbit renders + blends
    (`main_test_dimo.py:780-869`)."""
    opt = tr.opt
    tr.load_checkpoint(opt.test_stage, step=opt.get("test_step"))
    names = motions or tr.input_videos
    for name in names:
        vi = tr.input_videos.index(name)
        frames, traj_imgs, _, _ = test_cpts(
            tr, test_stage=opt.test_stage, latent_index=vi,
            motion_video_name=name)
        seq = render_sequence(tr, vi, opt.test_stage, "fixed")
        viz.write_video(os.path.join(opt.video_save_dir,
                                     f"paper_{name}_fixed.mp4"), seq)
        diag = render_sequence(tr, vi, opt.test_stage, "circle")
        viz.write_video(os.path.join(opt.video_save_dir,
                                     f"paper_{name}_orbit.mp4"), diag)
        _write_blend(opt.video_save_dir, f"paper_{name}", seq, traj_imgs)


def run_test_fps(tr, rounds: int = 500, size: int = 512) -> float:
    """Reference test_fps (`main_test_dimo.py:872-894`): 1 warmup + N timed
    renders at size^2 from the front camera, image only (channels=3), KNN
    computed once, at the run's capacity (`tile_capacity`, 512 by
    default). The clock is read after a device synchronize.
    spatial_parallel=N shards each frame's strips over N ranks (every rank
    runs this harness; `rasterize`'s `sp`)."""
    opt = tr.opt
    n_sp = int(opt.get("spatial_parallel", 1))
    sp = None
    if n_sp > 1:
        from dimo_tpu_torch.parallel import mesh as mesh_mod
        sp = mesh_mod.make_sp_mesh(n_sp, device=tr.device)
    tr.load_checkpoint(opt.test_stage, step=opt.get("test_step"))
    cfg, bg = tr.mcfg, torch.ones(3, device=tr.device)
    capacity = int(opt.get("tile_capacity", 512))
    stage = opt.test_stage
    params, aux = tr.state.params, tr.state.aux
    on_card = tr.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(tr.device)

    with torch.no_grad():
        knn = find_knn(params, aux) if stage >= "s2" else None
        cam = tr.camera_for(0)

        def fn():
            return render(cfg, params, aux, cam, 0.0, stage, 0, size, size, bg,
                          knn_cache=knn, capacity=capacity,
                          channels=3, sp=sp)["image"]

        fn()
        sync()
        t0 = time.time()
        for _ in range(rounds):
            fn()
        sync()
        t1 = time.time()
    fps = rounds / (t1 - t0)
    print(f"[INFO] FPS: {fps}")
    return fps
