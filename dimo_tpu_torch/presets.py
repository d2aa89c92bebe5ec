"""Config presets: a tiny synthetic configuration for tests and dry runs
(copy of `dimo_tpu/presets.py`, with the same keys and values)."""
from __future__ import annotations

import os
import tempfile

from dimo_tpu_torch.io.config import Config


def tiny_synthetic_opt(**kw) -> Config:
    """Minimal config for smoke tests / dry runs on synthetic data."""
    d = dict(
        input_folder="synthetic", input_videos=None, elevation=0, ref_size=64,
        save_path=os.path.join(tempfile.gettempdir(), "dimo_tpu_test_run"),
        save_path_new=None,
        train_dynamic=True, vae_latent=False,
        iters_s1=4, iters_s2=3, batch_size=1, radius=2, fovy=49.1,
        seed=0, H=128, W=128, num_frames=5, num_views=3, latent_code_dim=8,
        FPS_iter=1000,
        lambda_mse=5000.0, lambda_lpips=1000.0, lambda_ssim=500.0,
        lambda_mask=500.0, add_depth=True, depth_reg_start_iter=200,
        lambda_smooth=100.0, add_normal=True, normal_reg_start_iter=200,
        lambda_bilateral=0.05, add_ga=True, ga_chamfer=True,
        lambda_ga1=10.0, lambda_ga2=10000.0, use_arap=True,
        arap_start_iter_s1=1000, arap_end_iter_s2=2000, lambda_arap=10.0,
        lambda_kl=0.05, load_stage="", save_inter=100000,
        num_pts=100, num_cpts=24, sh_degree=0,
        opacity_lr=0.05, scaling_lr=0.005, percent_dense=0.01,
        density_start_iter=100, density_end_iter=1000,
        density_end_iter_s2=5000, densification_interval=100,
        densification_interval_s2=1000, opacity_reset_interval=200000,
        densify_grad_threshold=0.01, densify_opacity_threshold_s1=0.01,
        densify_opacity_threshold_s2=0.01,
        position_lr_init=0.01, position_lr_final=0.0002,
        position_lr_delay_mult=0.02, position_lr_max_steps=1000,
        feature_lr=0.01, rotation_lr=0.005, c_radius_lr=0.005,
        latent_code_lr_init=0.005, latent_code_lr_final=0.0002,
        latent_code_lr_delay_mult=0.02, latent_code_lr_max_steps=1000,
        deform_lr_init=0.0002, deform_lr_final=0.000002,
        deform_learn_start=0, deformation_lr_delay_mult=0.01,
        c_position_lr_init=0.000002, c_position_lr_final=0.000002,
        c_position_lr_delay_mult=0.02, r_lr=0.01,
        init_type="ag", init_ratio=1,
        capacity_s1=64, tile_capacity=64, num_pts_per_cpt=4,
        test_step=None, test_stage="s2", test_azi=0,
        video_save_dir=os.path.join(tempfile.gettempdir(),
                                    "dimo_tpu_test_videos"), render_type="fixed",
        lpips_weights=None, data_parallel=1,
    )
    d.update(kw)
    return Config(d)
