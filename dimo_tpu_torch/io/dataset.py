"""Multi-view video dataset loading.

Copy of `dimo_tpu/io/dataset.py` (the reference's loader,
`utils/load_utils.py` + `main_train_dimo.py:102-128`): frames at
`input_folder/<motion>/view_XX/<FF>.png`, foreground masks from the alpha
channel or cached `<FF>_mask.npy` files (matting is an offline
preprocessing step, `scripts/precompute_masks.py`).

Images are held on the host as uint8; `train/loop.py::Trainer` uploads
them to the device when they fit (`DEVICE_DATA_MAX_BYTES`). OpenCV is
imported by `_load_frame`, so importing this module does not need it.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def load_info(input_folder: str, num_views: int, num_frames: int,
              elevation: float, input_videos=None) -> dict:
    """Read info.json (azimuths/elevations/input_videos) with the reference's
    fallbacks (`main_train_dimo.py:63-82`)."""
    info_path = os.path.join(input_folder, "info.json")
    if os.path.exists(info_path):
        with open(info_path) as f:
            info = json.load(f)
        azimuths = info["azimuths_deg"]
        full_azimuths = info["full_azimuths_deg"]
        elevations = info["elevations_deg"]
        if input_videos is None:
            input_videos = info.get("input_videos")
            if input_videos is None:
                raise ValueError("Input videos list not provided!!!")
        if len(azimuths) != num_views:
            raise ValueError(f"info.json has {len(azimuths)} azimuths for "
                             f"num_views={num_views}")
    else:
        azimuths = [360 / num_views * i for i in range(num_views)]
        full_azimuths = [360 / num_frames * i for i in range(num_frames)]
        elevations = [elevation for _ in range(num_views)]
        if input_videos is None:
            input_videos = sorted(
                d for d in os.listdir(input_folder)
                if os.path.isdir(os.path.join(input_folder, d)))
    if isinstance(input_videos, str):
        input_videos = input_videos.split(",")
    return {
        "azimuths": azimuths,
        "full_azimuths": full_azimuths,
        "elevations": elevations,
        "input_videos": list(input_videos),
    }


def _load_frame(path: str, ref_size: int):
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    mask_path = path.replace(".png", "_mask.npy")
    if img.shape[-1] == 4:
        mask = img[..., 3].astype(np.float32) / 255.0
        rgb = img[..., :3]
    elif os.path.exists(mask_path):
        mask = np.load(mask_path).astype(np.float32)
        if mask.ndim == 3:
            mask = mask[..., 0]
        rgb = img
    else:
        raise FileNotFoundError(
            f"no alpha channel and no cached mask for {path}; run "
            "scripts/precompute_masks.py first")
    rgb = rgb[..., ::-1]  # BGR -> RGB
    if rgb.shape[0] != ref_size or rgb.shape[1] != ref_size:
        rgb = cv2.resize(rgb, (ref_size, ref_size), interpolation=cv2.INTER_LINEAR)
        mask = cv2.resize(mask, (ref_size, ref_size), interpolation=cv2.INTER_LINEAR)
    return rgb.astype(np.uint8), (mask * 255).astype(np.uint8)


def load_videos(input_folder: str, input_videos: list[str], num_views: int,
                num_frames: int, ref_size: int, workers: int = 8):
    """Load all frames -> (images u8 (M,V,F,S,S,3), masks u8 (M,V,F,S,S)),
    on a pool of `workers` threads (OpenCV releases the interpreter lock
    while it decodes)."""
    m = len(input_videos)
    images = np.zeros((m, num_views, num_frames, ref_size, ref_size, 3), np.uint8)
    masks = np.zeros((m, num_views, num_frames, ref_size, ref_size), np.uint8)

    jobs = [(mi, v, f) for mi in range(m) for v in range(num_views)
            for f in range(num_frames)]

    def work(job):
        mi, v, f = job
        path = os.path.join(input_folder, input_videos[mi],
                            f"view_{v:02d}", f"{f:02d}.png")
        img, msk = _load_frame(path, ref_size)
        images[mi, v, f] = img
        masks[mi, v, f] = msk

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(work, jobs))
    return images, masks
