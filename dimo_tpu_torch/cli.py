"""The port's command-line entry points: training and the test modes.

Counterparts of `main_train_dimo.py` and `main_test_dimo.py`, with the
same config keys, routes and precedence; the root scripts
`main_train_dimo_torch.py` and `main_test_dimo_torch.py` call
`train_main` / `test_main`:

    python main_train_dimo_torch.py --config configs/train_config.yaml \
        train_dynamic=True input_folder=... save_path=... key=value ...
    python main_test_dimo_torch.py --config configs/test_config.yaml \
        save_path=... input_folder=... test_motion=True ...

Everything runs on `device` ("cuda" unless a caller, such as a test, asks
for the CPU; there is no flag for it). `train_main` / `test_main` parse
the arguments and the YAML file (PyYAML); `run_train` / `run_test` are
the bodies below the parsing and take a `Config`. The TensorBoard loggers
are optional (tensorboardX), as in the reference.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from dimo_tpu_torch.utils.general import resolve_device


def _parse(argv, default_config: str):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=default_config, type=str,
                        help="path to the yaml config file")
    args, extras = parser.parse_known_args(argv)
    from dimo_tpu_torch.io.config import load_config
    return load_config(args.config, extras)


def _lpips(opt, device):
    """LPIPS as the reference CLIs set it: converted weights if present,
    else the seeded random-VGG fallback (`lpips_fallback=off` disables)."""
    from dimo_tpu_torch.models.lpips import get_lpips
    return get_lpips(opt.get("lpips_weights") or "weights/lpips_vgg.npz",
                     fallback=str(opt.get("lpips_fallback", "random")),
                     device=device)


# ---------------------------------------------------------------------------
# training

def train_main(argv=None, device="cuda"):
    """`main_train_dimo.py`'s CLI; returns the Trainer."""
    return run_train(_parse(argv, "./configs/train_config.yaml"), device)


def _train_logger(opt):
    """The reference's TensorBoard logger (`main_train_dimo.py:67-113`),
    or None without tensorboardX."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    tb = SummaryWriter(log_dir=os.path.join(opt.save_path, "tb"))

    def log_fn(stage, step, metrics, trainer=None):
        if step % 10 == 0:
            for k, v in metrics.items():
                if v.ndim == 0:
                    tb.add_scalar(f"{stage}/{k}", float(v), step)
            # render/gt image pair + latent histogram
            # (reference `main_train_dimo.py:403-412`)
            if "debug_render" in metrics:
                tb.add_image(f"{stage}/render",
                             metrics["debug_render"].cpu().numpy(), step)
                tb.add_image(f"{stage}/gt", metrics["debug_gt"].cpu().numpy(),
                             step)
            if trainer is not None:
                lat = trainer.state.params.latent
                code = lat.get("codes", lat.get("mu"))
                if code is not None:
                    tb.add_histogram(f"{stage}/latent_code",
                                     code.detach().cpu().numpy(), step)
        if step % 100 == 0 and "debug_render" in metrics:
            # side-by-side GT|render debug PNG
            # (reference `main_train_dimo.py:393-400`)
            import cv2
            gt = metrics["debug_gt"].cpu().numpy().transpose(1, 2, 0)
            rd = metrics["debug_render"].cpu().numpy().transpose(1, 2, 0)
            pair = np.concatenate([gt, rd], axis=1)
            dbg = os.path.join(opt.save_path, "debug")
            os.makedirs(dbg, exist_ok=True)
            cv2.imwrite(os.path.join(dbg, f"image_{stage}_{step}.png"),
                        (pair[..., ::-1].clip(0, 1) * 255).astype(np.uint8))
        if step % 100 == 0:
            print(f"[{stage} {step}] loss={float(metrics['loss']):.4f} "
                  f"psnr={float(metrics['psnr']):.2f}")
    return log_fn


def run_train(opt, device="cuda"):
    """The body of `main_train_dimo.py` below its argument parsing:
    synthetic or folder data, the Trainer, LPIPS, then `train_dynamic`
    or (train_dynamic=False) the default test. Returns the Trainer."""
    dev = resolve_device(device)
    from dimo_tpu_torch.io import dataset as dataset_io
    from dimo_tpu_torch.io import synthetic as synth_io
    from dimo_tpu_torch.io.config import save_config
    from dimo_tpu_torch.train.loop import Trainer

    num_views = int(opt.get("num_views", 9))
    num_frames = int(opt.get("num_frames", 21))

    if opt.input_folder == "synthetic":
        images, masks, meta = synth_io.make_synthetic_videos(
            num_motions=int(opt.get("synthetic_motions", 2)),
            num_views=num_views, num_frames=num_frames,
            ref_size=int(opt.ref_size), seed=int(opt.seed or 0),
            fovy_deg=float(opt.fovy), radius=float(opt.radius), device=dev)
    else:
        meta = dataset_io.load_info(opt.input_folder, num_views, num_frames,
                                    opt.elevation, opt.input_videos)
        print(f"[INFO] loading {len(meta['input_videos'])} motion videos ...")
        if opt.train_dynamic:
            images, masks = dataset_io.load_videos(
                opt.input_folder, meta["input_videos"], num_views, num_frames,
                int(opt.ref_size))
        else:
            m = len(meta["input_videos"])
            s = int(opt.ref_size)
            images = np.zeros((m, num_views, num_frames, s, s, 3), np.uint8)
            masks = np.zeros((m, num_views, num_frames, s, s), np.uint8)

    log_fn = None
    if opt.train_dynamic and opt.save_path:
        os.makedirs(opt.save_path, exist_ok=True)
        save_config(opt, os.path.join(opt.save_path, "config.yaml"))
        log_fn = _train_logger(opt)

    trainer = Trainer(opt, images, masks, meta, log_fn=log_fn, device=dev)
    lpips_fn = _lpips(opt, dev)

    if opt.save_path_new:
        opt.save_path = opt.save_path_new

    if opt.train_dynamic:
        # snapshot_every=N enables elastic mid-run recovery (see
        # Trainer.train_dynamic); 0 (default) = reference behavior
        trainer.train_dynamic(int(opt.iters_s1), int(opt.iters_s2),
                              opt.load_stage or "", lpips_fn=lpips_fn,
                              snapshot_every=int(opt.get("snapshot_every", 0)),
                              snapshot_dir=os.path.join(opt.save_path, "snap"))
    else:
        from dimo_tpu_torch.test_modes import run_default_test
        run_default_test(trainer, render_type=opt.render_type)
    return trainer


# ---------------------------------------------------------------------------
# the test modes

def test_main(argv=None, device="cuda"):
    """`main_test_dimo.py`'s CLI; returns what the routed mode returns."""
    return run_test(_parse(argv, "configs/test_config.yaml"), device)


def _test_logger(opt):
    """The reference's fine-tuning TensorBoard scalars
    (`main_test_dimo.py:58-67`), or None without tensorboardX."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return None
    tb = SummaryWriter(log_dir=os.path.join(str(opt.save_path), "tb_test"))

    def log_fn(it, metrics):
        for k in ("loss", "psnr", "ssim_loss", "lpips", "mse", "mask_loss"):
            tb.add_scalar(f"finetune/{k}", float(metrics[k]), it)
    return log_fn


def run_test(opt, device="cuda"):
    """The body of `main_test_dimo.py` below its argument parsing. Routes,
    first match wins: test_fps, test_motion, test_unaligned_motion,
    test_language, test_interpolation, test_paper, else the default test
    (`main_test_dimo.py:70-96`)."""
    dev = resolve_device(device)
    from dimo_tpu_torch import test_modes
    from dimo_tpu_torch.io import dataset as dataset_io
    from dimo_tpu_torch.train.loop import Trainer

    num_views = int(opt.get("num_views", 9))
    num_frames = int(opt.get("num_frames", 21))
    meta = dataset_io.load_info(opt.input_folder, num_views, num_frames,
                                opt.elevation, opt.input_videos)
    m = len(meta["input_videos"])
    s = int(opt.ref_size)
    images = np.zeros((m, num_views, num_frames, s, s, 3), np.uint8)
    masks = np.zeros((m, num_views, num_frames, s, s), np.uint8)
    tr = Trainer(opt, images, masks, meta, device=dev)

    def load_motion_data(folder):
        info = dataset_io.load_info(folder, num_views, num_frames,
                                    opt.elevation, None)
        imgs, msks = dataset_io.load_videos(
            folder, info["input_videos"][:1], num_views, num_frames, s)
        return imgs[0], msks[0]

    # perceptual loss for the finetuning modes (the reference applies LPIPS
    # at test-time finetune steps, `main_test_dimo.py:979,1160,1284`)
    lpips_fn = _lpips(opt, dev)
    log_fn = _test_logger(opt) if opt.save_path else None

    if opt.get("test_fps"):
        return test_modes.run_test_fps(tr)
    if opt.test_motion:
        imgs, msks = load_motion_data(opt.test_motion_data)
        return test_modes.run_test_motion(tr, imgs, msks, lpips_fn=lpips_fn,
                                          log_fn=log_fn)
    if opt.test_unaligned_motion:
        imgs, msks = load_motion_data(opt.test_unaligned_motion_data)
        return test_modes.run_test_unaligned_motion(
            tr, imgs, msks, lpips_fn=lpips_fn, log_fn=log_fn)
    if opt.test_language:
        text_emb = None
        if opt.get("test_text_emb"):
            # precomputed BERT pooled embedding (.npy) for environments
            # without the bert-base-cased weights cached
            text_emb = np.load(opt.test_text_emb)
            if text_emb.ndim == 2:
                text_emb = text_emb[0]
        return test_modes.run_test_language(tr, opt.test_text_prompt,
                                            render_type=opt.render_type,
                                            text_emb=text_emb)
    if opt.test_interpolation:
        return test_modes.run_test_interpolation(tr,
                                                 render_type=opt.render_type)
    if opt.test_paper:
        return test_modes.run_test_paper(tr)
    return test_modes.run_default_test(tr, render_type=opt.render_type)
