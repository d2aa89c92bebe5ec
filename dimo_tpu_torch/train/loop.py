"""Host-side training orchestration: stages, batching, densify cadence, IO.

Counterpart of `dimo_tpu/train/loop.py::Trainer`: stage-1 motion
pretraining then stage-2 joint refinement, with the reference's batch
sampling, resolution schedule, densify / prune / opacity-reset cadence,
FPS anneal, checkpoint layout, capacity escalation and elastic snapshots.
The same seed draws the same (motion, view, frame) batches as the JAX
trainer: both use `random.Random(seed)` for frames and views and the
global `np.random` for motions.

What differs, by PyTorch's idiom: the state is updated in place
(`train/step.py`, `models/gaussians.py`), nothing is jitted (step
functions are still cached per (stage, resolution, batch shape,
capacity), as closures), and the random streams of the split noise, the
ARAP samples and the VAE noise come from `torch.Generator`s, so those
numbers are not the JAX package's.

LPIPS comes in as `lpips_fn` (`models/lpips.get_lpips`), as in the
reference. Not here yet: data parallelism (raises) and the native
double-buffered batch packer (the host path gathers with numpy).
"""
from __future__ import annotations

import dataclasses
import json
import os
import random

import numpy as np
import torch

from dimo_tpu_torch.io import checkpoint as ckpt_io
from dimo_tpu_torch.io import ply as ply_io
from dimo_tpu_torch.models import gaussians as G
from dimo_tpu_torch.ops import sh as sh_ops
from dimo_tpu_torch.train.step import LossConfig, init_state, make_train_step
from dimo_tpu_torch.utils import cameras
from dimo_tpu_torch.utils.general import resolve_device

# the dataset is kept on the device when it is at most this large
DEVICE_DATA_MAX_BYTES = 2 << 30
CAM_NEAR, CAM_FAR = 0.01, 100.0
_SNAPSHOT_FILES = ("snapshot_meta.json", "snapshot_state.npz",
                   "snapshot_cpts.npz")


def loss_config_from_opt(opt, stage: str) -> LossConfig:
    """A LossConfig from the run's options, with the reference's per-stage
    schedule rewrites (`prepare_train_s1/s2`)."""
    if stage == "s1":
        pos_init, pos_final, pos_max = opt.position_lr_init, opt.position_lr_final, 500
    else:
        pos_init, pos_final, pos_max = 0.0002, 0.000002, int(opt.iters_s2)
    return LossConfig(
        lambda_mse=opt.lambda_mse, lambda_lpips=opt.lambda_lpips,
        lambda_ssim=opt.lambda_ssim, lambda_mask=opt.lambda_mask,
        lambda_smooth=opt.lambda_smooth, lambda_bilateral=opt.lambda_bilateral,
        lambda_arap=opt.lambda_arap, lambda_kl=opt.lambda_kl,
        lambda_ga1=opt.lambda_ga1, lambda_ga2=opt.lambda_ga2,
        add_depth=opt.add_depth, add_normal=opt.add_normal,
        add_ga=opt.add_ga, ga_chamfer=opt.ga_chamfer, use_arap=opt.use_arap,
        vae=opt.vae_latent,
        depth_reg_start_iter=opt.depth_reg_start_iter,
        normal_reg_start_iter=opt.normal_reg_start_iter,
        arap_start_iter_s1=opt.arap_start_iter_s1,
        arap_end_iter_s2=opt.arap_end_iter_s2,
        fps_iter=int(opt.FPS_iter),
        density_start_iter=int(opt.density_start_iter),
        density_end_iter=int(opt.density_end_iter),
        position_lr_init=pos_init, position_lr_final=pos_final,
        position_lr_max_steps=pos_max,
        c_position_lr_init=opt.c_position_lr_init,
        c_position_lr_final=opt.c_position_lr_final,
        latent_code_lr_init=opt.latent_code_lr_init,
        latent_code_lr_final=opt.latent_code_lr_final,
        deform_lr_init=opt.deform_lr_init, deform_lr_final=opt.deform_lr_final,
        feature_lr=opt.feature_lr, opacity_lr=opt.opacity_lr,
        scaling_lr=opt.scaling_lr, rotation_lr=opt.rotation_lr,
        c_radius_lr=opt.c_radius_lr, r_lr=opt.r_lr,
        grad_clip_norm=float(opt.get("grad_clip_norm", 0.0)),
    )


def render_resolution_for_step(step: int) -> int:
    """128 -> 256 -> 512 at steps 300/450."""
    return 128 if step < 300 else (256 if step < 450 else 512)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class Trainer:
    """Owns data, model state, and the stage loops."""

    def __init__(self, opt, images: np.ndarray, masks: np.ndarray, meta: dict,
                 log_fn=None, device="cuda"):
        """images: uint8 (M, V, F, S, S, 3); masks: uint8 (M, V, F, S, S).
        meta: azimuths / elevations / input_videos. log_fn(stage, step,
        metrics, trainer=self) is called after every step."""
        dp = int(opt.get("data_parallel", 1) or 1)
        if dp > 1:
            raise NotImplementedError(
                "data_parallel > 1 is not ported yet (ROADMAP.md Queue A, "
                "`parallel/mesh.py`)")
        self.device = resolve_device(device)
        self.opt = opt
        self.images = images
        self.masks = masks
        self.meta = meta
        self.input_videos = meta["input_videos"]
        self.azimuths = meta["azimuths"]
        self.num_motions = len(self.input_videos)
        self.num_views = int(opt.get("num_views", 9))
        self.num_frames = int(opt.get("num_frames", 21))
        self.log_fn = log_fn or (lambda *a, **k: None)

        self.fovy = np.deg2rad(opt.fovy)
        self.fovx = 2 * np.arctan(np.tan(self.fovy / 2) * opt.W / opt.H)
        self.cam_near, self.cam_far = CAM_NEAR, CAM_FAR

        self.seed = int(opt.seed) if str(opt.seed).isdigit() else 0
        random.seed(self.seed)
        np.random.seed(self.seed)
        self.py_rng = random.Random(self.seed)

        self.stage = "s1"
        self.step = 0
        self.cpts_s1 = None            # (M, F, Mc, 3) cached guidance, numpy
        self._step_fns = {}
        self._pending_meta = None      # a batch's meta set ahead by a caller
        # device-resident dataset: uploaded once when it fits, so a batch
        # is a row gather on the device instead of a host->device copy of
        # the ground truth every step
        self._dev_images = self._dev_masks = None
        self._dev_cpts = None
        self._upload_dataset()
        self.tile_capacity = int(opt.get("tile_capacity", 512))
        self._overflow_strikes = 0
        self._last_b = 1

        self.mcfg = G.ModelConfig(
            sh_degree=opt.sh_degree, latent_dim=opt.latent_code_dim,
            num_latents=self.num_motions, vae=bool(opt.vae_latent),
            capacity=int(opt.get("capacity_s1", 8192)),
            cpt_capacity=int(opt.num_cpts),
            percent_dense=opt.percent_dense)
        params, aux = G.init_model(self.mcfg, seed=self.seed,
                                   num_pts=int(opt.num_cpts),
                                   num_cpts=int(opt.num_cpts),
                                   device=self.device)
        self.state = init_state(params, aux, step=0, seed=self.seed)

    def _upload_dataset(self) -> None:
        """Copy the frames and masks to the device when together they fit
        under DEVICE_DATA_MAX_BYTES."""
        if self.images.nbytes + self.masks.nbytes <= DEVICE_DATA_MAX_BYTES:
            self._dev_images = torch.from_numpy(self._flat(self.images)).to(
                self.device)
            self._dev_masks = torch.from_numpy(self._flat(self.masks)).to(
                self.device)

    @staticmethod
    def _flat(frames: np.ndarray) -> np.ndarray:
        """(M, V, F, ...) -> (M*V*F, ...)."""
        return frames.reshape((-1,) + frames.shape[3:])

    # ------------------------------------------------------------------
    # batching

    def camera_for(self, azimuth: float) -> cameras.Camera:
        pose = cameras.orbit_camera(self.opt.elevation, azimuth, self.opt.radius)
        return cameras.Camera.from_c2w(pose, self.fovx, self.fovy,
                                       self.cam_near, self.cam_far)

    def _sample_meta(self) -> dict:
        """Draw one batch's (motion, view, frame) tuples and the fields that
        are cheap on the host: batch_size frames x batch_size views x
        min(2 * batch_size, M) motions."""
        bs = int(self.opt.batch_size)
        frames = self.py_rng.sample(range(self.num_frames), min(bs, self.num_frames))
        views = self.py_rng.sample(range(self.num_views), min(bs, self.num_views))
        n_sel = min(2 * bs, self.num_motions)
        motions = np.random.choice(self.num_motions, n_sel, replace=False)

        cams, times, lat_idx, mse_w, mvf = [], [], [], [], []
        for m in motions:
            for v in views:
                for f in frames:
                    cams.append(self.camera_for(self.azimuths[v]))
                    times.append(f / self.num_frames)
                    lat_idx.append(m)
                    mse_w.append(1.0 if (v == 0 or f == 0) else 0.5)
                    mvf.append((m, v, f))
        mvf = np.asarray(mvf, np.int64)
        flat = (mvf[:, 0] * self.num_views + mvf[:, 1]) * self.num_frames \
            + mvf[:, 2]
        return {
            "cams": cams, "times": times, "lat_idx": lat_idx, "mse_w": mse_w,
            "mvf": mvf, "flat": flat,
            "shape": (n_sel, len(views), len(frames)),
        }

    def sample_batch(self):
        """Assemble one batch: a row gather on the device when the dataset
        lives there, else one numpy fancy-index gather and an upload."""
        meta = self._pending_meta or self._sample_meta()
        self._pending_meta = None
        if self._dev_images is not None:
            flat = torch.from_numpy(meta["flat"]).to(self.device)
            return self._finish_batch(meta, self._dev_images[flat],
                                      self._dev_masks[flat])
        gt_i = torch.from_numpy(self._flat(self.images)[meta["flat"]])
        gt_m = torch.from_numpy(self._flat(self.masks)[meta["flat"]])
        return self._finish_batch(meta, gt_i.to(self.device),
                                  gt_m.to(self.device))

    def _finish_batch(self, meta, gt_i, gt_m):
        batch = {
            "camera": meta["cams"],
            "times": np.asarray(meta["times"], np.float32),
            "latent_idx": np.asarray(meta["lat_idx"], np.int32),
            "mse_w": np.asarray(meta["mse_w"], np.float32),
            "gt_image": gt_i,
            "gt_mask": gt_m,
        }
        if self.cpts_s1 is not None:
            if self._dev_cpts is None:
                self._dev_cpts = torch.from_numpy(self.cpts_s1).to(self.device)
            batch["guidance"] = self._dev_cpts[
                torch.from_numpy(meta["mvf"][:, 0]).to(self.device),
                torch.from_numpy(meta["mvf"][:, 2]).to(self.device)]
        return batch, meta["shape"]

    # ------------------------------------------------------------------
    # step functions (cached per (stage, resolution, batch shape, capacity))

    def get_step_fn(self, stage, res, shape, lpips_fn=None):
        """The step for this key; `lpips_fn` is not part of the key (the
        reference's cache): a run passes the same one to every step."""
        key = (stage, res, shape, self.tile_capacity)
        if key not in self._step_fns:
            lcfg = loss_config_from_opt(self.opt, stage)
            n_motions, n_views, n_frames = shape
            self._step_fns[key] = make_train_step(
                self.mcfg, lcfg, stage, res, res,
                n_motions, n_views, n_frames,
                capacity=self.tile_capacity,
                lpips_fn=lpips_fn,
                use_guidance=(stage >= "s2"))
        return self._step_fns[key]

    def _check_overflow(self, metrics):
        """Adaptive strip-capacity escalation: the lists report dropped
        entries, and persistent heavy overflow doubles the capacity
        instead of truncating for the rest of the run. Checked every 10
        steps to avoid a host read per step."""
        if self.step % 10 != 0:
            return
        cap_max = int(self.opt.get("tile_capacity_max", 4096))
        if self.tile_capacity >= cap_max:
            return
        ov = float(metrics["overflow"])
        ovm = float(metrics.get("overflow_max", 0.0))
        # sustained heavy truncation: EITHER one strip drops > 25% of its
        # capacity (truncation concentrated in one silhouette-dense strip,
        # which the batch total dilutes), OR the drops per render exceed
        # 25% of one strip's capacity
        if (ovm > 0.25 * self.tile_capacity
                or ov / self._last_b > 0.25 * self.tile_capacity):
            self._overflow_strikes += 1
        else:
            self._overflow_strikes = 0
        if self._overflow_strikes >= 3:
            self.tile_capacity = min(self.tile_capacity * 2, cap_max)
            self._overflow_strikes = 0
            print(f"[capacity] tile overflow sustained; tile_capacity -> "
                  f"{self.tile_capacity}")

    # ------------------------------------------------------------------
    # training

    def train_dynamic(self, iters_s1: int, iters_s2: int, load_stage: str = "",
                      lpips_fn=None, snapshot_every: int = 0,
                      snapshot_dir: str = ""):
        """Two-stage schedule. snapshot_every/snapshot_dir enable ELASTIC
        resume: every N steps the full TrainState (with Adam moments and
        the cached s1 trajectories) is written atomically, and calling
        train_dynamic again with the same directory continues from the
        last snapshot (the host batch RNG is reseeded, so the batch
        sequence after a resume differs from an uninterrupted run)."""
        if load_stage >= "s1":
            iters_s1 = 0
        if load_stage >= "s2":
            iters_s2 = 0
        if load_stage:
            self.load_checkpoint(load_stage)

        # an explicit load_stage overrides a snapshot of the SAME or an
        # EARLIER phase; a snapshot of a LATER phase is this run's own
        # progress past the loaded stage and wins
        snap = bool(snapshot_every and snapshot_dir)
        start_s1 = start_s2 = 0
        s2_prepared = False
        if snap:
            # peek BEFORE load_snapshot (which replaces the state): a
            # discarded snapshot must not clobber the checkpoint just loaded
            peek = self.peek_snapshot_phase(snapshot_dir)
            use = peek is not None and (not load_stage or peek > load_stage)
            meta = self.load_snapshot(snapshot_dir) if use else None
            if meta is not None:
                if meta["phase"] == "s1":
                    start_s1 = meta["done"]
                else:
                    start_s1 = iters_s1
                    start_s2 = meta["done"]
                    s2_prepared = True   # the snapshot is post-prepare
                print(f"[snapshot] resumed {meta['phase']} after "
                      f"{meta['done']} iters (step {self.step})")

        if iters_s1 > 0 and not s2_prepared:
            if start_s1 == 0:
                self.prepare_train_s1()
            # min(): a snapshot beyond a REDUCED iters_s1 still runs
            # finish_s1 (prune + checkpoint) instead of skipping the stage
            for i in range(min(start_s1, iters_s1), iters_s1):
                self.train_step_once(lpips_fn)
                if snap and (i + 1) % snapshot_every == 0 and i + 1 < iters_s1:
                    self.save_snapshot(snapshot_dir, "s1", i + 1)
            self.finish_s1()

        if iters_s2 > 0:
            if not s2_prepared:
                self.prepare_train_s2()
                if snap:
                    # a failure early in s2 must not redo s1
                    self.save_snapshot(snapshot_dir, "s2", 0)
            for i in range(min(start_s2, iters_s2), iters_s2):
                self.train_step_once(lpips_fn)
                if snap and (i + 1) % snapshot_every == 0 and i + 1 < iters_s2:
                    self.save_snapshot(snapshot_dir, "s2", i + 1)
            self.finish_s2()

        # the run completed: retire the snapshot so a RE-RUN of the same
        # command trains fresh instead of resuming a finished run
        if snap:
            self.clear_snapshot(snapshot_dir)

    def train_step_once(self, lpips_fn=None):
        opt = self.opt
        self.step += 1
        res = render_resolution_for_step(self.step)
        batch, shape = self.sample_batch()
        step_fn = self.get_step_fn(self.stage, res, shape, lpips_fn)
        self._last_b = max(1, len(batch["times"]))
        self.state, metrics = step_fn(self.state, batch)
        if int(metrics["nonfinite_grad"]):
            print(f"[guard] step {self.step}: non-finite/overflow gradient "
                  f"(sup={float(metrics['grad_sup']):.2e} "
                  f"l2={float(metrics['grad_norm']):.2e}): update skipped "
                  "(params/moments untouched)")
        self._check_overflow(metrics)
        self.log_fn(self.stage, self.step, metrics, trainer=self)

        # checkpoint cadence
        if self.step % int(opt.save_inter) == 0:
            self.save_checkpoint(self.stage, step=self.step)

        # densify / prune cadence
        if self.stage == "s1":
            if self.step % int(opt.FPS_iter) == 0:
                self._apply_fps()
            in_window = (self.step % int(opt.FPS_iter) >= int(opt.density_start_iter)
                         and self.step <= int(opt.density_end_iter))
            if in_window and self.step % int(opt.densification_interval) == 0:
                self._apply_densify_prune()
            if in_window and self.step % int(opt.opacity_reset_interval) == 0:
                self._apply_opacity_reset()
        elif self.stage == "s2" and self.step < int(opt.density_end_iter_s2):
            if (self.step % int(opt.densification_interval_s2) == 0
                    and opt.init_type == "ag"):
                self._apply_prune_only()

    # ------------------------------------------------------------------
    # densification wrappers

    def _moments(self):
        return self.state.opt.mu, self.state.opt.nu

    def _apply_densify_prune(self):
        s, opt = self.state, self.opt
        _, s.aux, _ = G.densify_and_prune(
            self.mcfg, s.params, s.aux, self._moments(), self.stage,
            max_grad=opt.densify_grad_threshold,
            min_opacity=opt.densify_opacity_threshold_s1,
            extent=4.0, max_screen_size=1.0, generator=s.rng)
        n = int(G.num_active(s.aux))
        print(f"Num of gaussians: {n}")
        if n > 0.9 * self.mcfg.capacity:
            self._grow_capacity(self.mcfg.capacity * 2)

    def _apply_prune_only(self):
        s = self.state
        _, s.aux = G.prune_only(
            self.mcfg, s.params, s.aux, self.stage,
            min_opacity=self.opt.densify_opacity_threshold_s2,
            extent=4.0, max_screen_size=1.0)
        print(f"Num of gaussians after pruning: {int(G.num_active(s.aux))}")

    def _apply_fps(self):
        s = self.state
        _, s.aux = G.fps_anneal(s.params, s.aux, int(self.opt.num_cpts))

    def _apply_opacity_reset(self):
        G.reset_opacity(self.state.params, self._moments())

    def _grow_capacity(self, new_cap: int):
        """Pad all per-gaussian tensors (parameters, bookkeeping, Adam
        moments) to a larger capacity. New slots are inactive blanks."""
        print(f"[capacity] growing {self.mcfg.capacity} -> {new_cap}")
        s = self.state
        old = self.mcfg.capacity
        fills = {"scaling": -10.0, "opacity": -10.0}

        def pad(x, fill=0.0):
            out = torch.full((new_cap,) + tuple(x.shape[1:]), fill,
                             dtype=x.dtype, device=x.device)
            out[:old] = x.detach()
            return out

        new = {name: pad(getattr(s.params, name), fills.get(name, 0.0))
               for name in G._PER_GAUSSIAN}
        new["rotation"][old:, 0] = 1.0
        for leaf in new.values():
            leaf.requires_grad_(True)
        s.params = s.params.replace(**new)
        s.aux = s.aux.replace(
            active=pad(s.aux.active, False),
            max_radii2d=pad(s.aux.max_radii2d),
            xyz_grad_accum=pad(s.aux.xyz_grad_accum),
            denom=pad(s.aux.denom))
        for m in self._moments():
            for name in G._PER_GAUSSIAN:
                m[name] = pad(m[name])
        self.mcfg = dataclasses.replace(self.mcfg, capacity=new_cap)
        self._step_fns.clear()

    # ------------------------------------------------------------------
    # stage transitions

    def prepare_train_s1(self):
        self.stage = "s1"
        self.step = 0
        self.state.step = 0

    def finish_s1(self):
        """Prune the stage-1 blob by opacity (< 0.01), then checkpoint."""
        s = self.state
        with torch.no_grad():
            keep = s.aux.active & (G.get_opacity(s.params)[:, 0] >= 0.01)
        s.aux = s.aux.replace(active=keep)
        print("Num of cpts after s1: ", int(keep.sum()))
        self.save_checkpoint("s1")

    def prepare_train_s2(self):
        """Copy the s1 blob into the control points, AG-init the dense
        Gaussians around them, start a fresh optimizer, cache the s1
        trajectories for the guidance loss."""
        s = self.state
        p = s.params
        idx = torch.nonzero(s.aux.active)[:, 0]
        k = int(idx.shape[0])

        cpt_cap = max(int(self.opt.num_cpts), k)
        n_per = int(self.opt.get("num_pts_per_cpt", 200))
        cap_s2 = _round_up(k * n_per, 2048)
        self.mcfg = dataclasses.replace(self.mcfg, capacity=cap_s2,
                                        cpt_capacity=cpt_cap)

        params2, aux2 = G._blank(self.mcfg, self.device)
        with torch.no_grad():
            params2.c_xyz[:k] = p.xyz[idx]
            params2.c_radius.fill_(float(p.r[0, 0]))
            aux2.c_active[:k] = True
        params2 = params2.replace(r=p.r.detach().clone(), latent=p.latent,
                                  timenet=p.timenet)
        c_active = aux2.c_active
        if self.opt.init_type == "ag":
            params2, aux2 = G.initialize_ag(
                self.mcfg, params2, aux2, seed=self.seed,
                num_pts_per_cpt=n_per, init_ratio=self.opt.init_ratio)
        else:
            rng = np.random.RandomState(self.seed)
            pts = G._random_ball(rng, int(self.opt.num_pts), 0.5)
            colors = sh_ops.sh_to_rgb(
                rng.random((pts.shape[0], 3)).astype(np.float32) / 255.0)
            params2, aux2 = G.set_points_from_cloud(self.mcfg, params2, aux2,
                                                    pts, colors)
        aux2 = aux2.replace(c_active=c_active)

        self.state = init_state(params2, aux2, step=0, seed=self.seed)
        self.state.rng = s.rng
        self.stage = "s2"
        self.step = 0
        self._step_fns.clear()
        self.cache_s1_trajectories()

    @torch.no_grad()
    def cache_s1_trajectories(self):
        """Cache every motion's control-point trajectory for the guidance
        loss, (M, F, Mc, 3): ONE batched TimeNet call over (motion, frame).
        VAE latents are SAMPLED by reparameterization, not collapsed to the
        mean, from a generator seeded seed + 7."""
        p = self.state.params
        n_f, n_m = self.num_frames, self.num_motions
        gen = torch.Generator().manual_seed(self.seed + 7)
        lat = torch.stack([G.sample_latent(p, m, gen if self.mcfg.vae else None)
                           for m in range(n_m)])                   # (M, L)
        ts = torch.arange(n_f, dtype=torch.float32, device=self.device) / n_f
        shape = (n_m, n_f, p.c_xyz.shape[0])
        pts = p.c_xyz.expand(*shape, 3)
        d, _ = p.timenet(pts, ts[None, :, None, None],
                         lat[:, None, None, :].expand(*shape, lat.shape[-1]))
        self.cpts_s1 = (pts + d).cpu().numpy()
        self._dev_cpts = None          # refresh the device guidance cache

    def finish_s2(self):
        self.save_checkpoint("s2")

    # ------------------------------------------------------------------
    # checkpoint IO (the reference's directory layout)

    def save_checkpoint(self, stage: str, step=None):
        save_path = os.path.join(self.opt.save_path, stage)
        os.makedirs(save_path, exist_ok=True)
        s = self.state
        p = s.params
        idx = torch.nonzero(s.aux.active)[:, 0]
        suffix = f"_{step}" if step else ""

        def rows(x, at=idx):
            return x.detach()[at].cpu().numpy()

        if stage == "s1":
            scale = np.broadcast_to(p.r.detach().cpu().numpy(), (len(idx), 3))
        else:
            scale = rows(p.scaling)
        ply_io.save_gaussians(
            os.path.join(save_path, f"point_cloud{suffix}.ply"),
            rows(p.xyz), rows(p.features_dc), rows(p.features_rest),
            rows(p.opacity), scale, rows(p.rotation))
        if stage >= "s2":
            c_idx = torch.nonzero(s.aux.c_active)[:, 0]
            ply_io.save_control_points(
                os.path.join(save_path, f"point_cloud_c{suffix}.ply"),
                rows(p.c_xyz, c_idx), rows(p.c_radius, c_idx))
        ckpt_io.save_model(save_path, p.latent, p.timenet, step=step)

    def save_full_state(self, path: str):
        """Full resumable state, Adam moments included."""
        ckpt_io.save_train_state(path, self.state)

    def load_full_state(self, path: str):
        self.state = ckpt_io.load_train_state(path, self.device)

    # ------------------------------------------------------------------
    # elastic mid-run snapshots (see train_dynamic)

    def save_snapshot(self, dir_path: str, phase: str, done: int):
        """Atomic full-progress snapshot: the TrainState (with Adam
        moments), the cached s1 trajectories, and the host-side scalars
        needed to continue. Each file is written under a temporary name
        and renamed, state -> cpts -> meta, so a failure mid-write never
        corrupts the previous snapshot."""
        os.makedirs(dir_path, exist_ok=True)

        def atomic(name, writer):
            # the temporary name keeps the extension (np.savez appends
            # .npz to a name that lacks it, which would break the rename)
            tmp = os.path.join(dir_path, "tmp_" + name)
            writer(tmp)
            os.replace(tmp, os.path.join(dir_path, name))

        meta = {"phase": phase, "done": int(done), "step": int(self.step),
                "stage": self.stage, "capacity": int(self.mcfg.capacity),
                "cpt_capacity": int(self.mcfg.cpt_capacity),
                "tile_capacity": int(self.tile_capacity)}

        def write_json(path):
            with open(path, "w") as f:
                json.dump(meta, f)

        atomic("snapshot_state.npz",
               lambda p: ckpt_io.save_train_state(p, self.state))
        if self.cpts_s1 is not None:
            atomic("snapshot_cpts.npz",
                   lambda p: np.savez(p, cpts_s1=self.cpts_s1))
        atomic("snapshot_meta.json", write_json)

    def clear_snapshot(self, dir_path: str):
        for name in _SNAPSHOT_FILES:
            try:
                os.remove(os.path.join(dir_path, name))
            except FileNotFoundError:
                pass

    def peek_snapshot_phase(self, dir_path: str):
        """Phase ("s1"/"s2") of the snapshot in dir_path, or None, without
        restoring it."""
        meta_path = os.path.join(dir_path, "snapshot_meta.json")
        if not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            return json.load(f).get("phase")

    def load_snapshot(self, dir_path: str):
        """Restore a save_snapshot; returns its meta dict, or None if there
        is none or it is inconsistent. Leaf shapes come from the snapshot,
        so a capacity grown between snapshots is fine; the host batch RNG
        is reseeded from (seed, step)."""
        meta_path = os.path.join(dir_path, "snapshot_meta.json")
        if not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        new_state = ckpt_io.load_train_state(
            os.path.join(dir_path, "snapshot_state.npz"), self.device)
        # files are renamed state -> cpts -> meta; a crash between renames
        # can mix generations. state.step mirrors the host step counter, so
        # a mismatch detects the mix: refuse the snapshot rather than
        # resume with a desynced LR/densify cadence or stale capacities.
        if new_state.step != int(meta["step"]):
            print(f"[snapshot] IGNORED inconsistent snapshot in {dir_path}: "
                  f"state.step={new_state.step} != meta.step={meta['step']} "
                  "(crash mid-save?); starting fresh")
            return None
        # an Inf/NaN Adam moment freezes its coordinate for good; zeroing
        # it just restarts that coordinate's moment average
        nbad = 0
        for m in (new_state.opt.mu, new_state.opt.nu):
            for k, v in m.items():
                bad = ~torch.isfinite(v)
                nbad += int(bad.sum())
                m[k] = torch.where(bad, torch.zeros_like(v), v)
        if nbad:
            print(f"[snapshot] sanitized {nbad} non-finite Adam moment "
                  "entries")
        self.mcfg = dataclasses.replace(
            self.mcfg, capacity=int(meta["capacity"]),
            cpt_capacity=int(meta["cpt_capacity"]))
        self.state = new_state
        cpts_path = os.path.join(dir_path, "snapshot_cpts.npz")
        if os.path.exists(cpts_path):
            with np.load(cpts_path) as z:
                self.cpts_s1 = np.asarray(z["cpts_s1"])
            self._dev_cpts = None      # refresh the device guidance cache
        self.step = int(meta["step"])
        self.stage = meta["stage"]
        # clamp to the CURRENT ceiling: a snapshot written before the
        # ceiling was lowered must not resume above it
        self.tile_capacity = min(
            int(meta["tile_capacity"]),
            int(self.opt.get("tile_capacity_max", 4096)))
        self._step_fns.clear()
        self.py_rng = random.Random(self.seed + self.step)
        np.random.seed((self.seed + self.step) % (2 ** 31))
        return meta

    def load_checkpoint(self, stage: str, step=None):
        load_path = os.path.join(self.opt.save_path, stage)
        suffix = f"_{step}" if step else ""
        g = ply_io.load_gaussians(
            os.path.join(load_path, f"point_cloud{suffix}.ply"),
            self.mcfg.sh_degree)
        n = g["xyz"].shape[0]
        if n > self.mcfg.capacity:
            self.mcfg = dataclasses.replace(
                self.mcfg, capacity=_round_up(max(n, 1), 2048))

        def fill(base, rows_np):
            k = rows_np.shape[0]
            base[:k] = torch.from_numpy(np.ascontiguousarray(
                rows_np, np.float32)).to(base.device)

        cpath = os.path.join(load_path, f"point_cloud_c{suffix}.ply")
        has_cpts = stage >= "s2" and os.path.exists(cpath)
        if has_cpts:
            c = ply_io.load_control_points(cpath)
            kc = c["c_xyz"].shape[0]
            self.mcfg = dataclasses.replace(
                self.mcfg, cpt_capacity=max(self.mcfg.cpt_capacity, kc))
        else:
            # an s1 checkpoint: the gaussians ARE the control points
            kc = min(n, self.mcfg.cpt_capacity)
            c = {"c_xyz": g["xyz"][:kc]}

        params, aux = G._blank(self.mcfg, self.device)
        with torch.no_grad():
            for name in G._PER_GAUSSIAN:
                fill(getattr(params, name), g[name])
            aux.active[:n] = True
            fill(params.c_xyz, c["c_xyz"])
            if has_cpts:
                fill(params.c_radius, c["c_radius"])
            aux.c_active[:kc] = True

        latent, timenet = ckpt_io.load_model(load_path, step=step,
                                             vae=self.mcfg.vae,
                                             device=self.device)
        params = params.replace(latent=latent, timenet=timenet)
        self.state = init_state(params, aux, step=0, seed=self.seed)
        self._step_fns.clear()
