"""The port's data-in modules against the JAX package's, on the CPU:
`io/dataset.py` (`load_info`, `_load_frame`, `load_videos`), `io/colmap.py`
and `Camera.from_intrinsics`.

Inputs: a folder of PNGs written here from a numpy seed, two motions of
2 views x 3 frames: RGBA frames at 48x48 (resized to 32: cv2's bilinear
resize of the colours and of the alpha mask), RGB frames with a
`_mask.npy` (2-D and 3-D masks), one RGB frame without a mask, an
`info.json` folder and one that falls back to the directory listing.

Tolerances: none. The loaders run the same numpy and OpenCV calls in
both packages, so their arrays must be equal; so must every field of the
colmap helpers and of `from_intrinsics` (the same numpy code, float32).
"""
import json
import os

import numpy as np
import pytest

from dimo_tpu.io import colmap as jcol
from dimo_tpu.io import dataset as jds
from dimo_tpu.utils import cameras as jcams

from dimo_tpu_torch.io import colmap as tcol
from dimo_tpu_torch.io import dataset as tds
from dimo_tpu_torch.utils import cameras as tcams

VIEWS, FRAMES, REF = 2, 3, 32


def _write_motion(root, name, kind, rng, size):
    """One motion folder: 'rgba' frames, or 'rgb' frames with `_mask.npy`
    (2-D for even frames, 3-D for odd ones)."""
    import cv2
    for v in range(VIEWS):
        d = os.path.join(root, name, f"view_{v:02d}")
        os.makedirs(d, exist_ok=True)
        for f in range(FRAMES):
            path = os.path.join(d, f"{f:02d}.png")
            rgb = rng.randint(0, 256, (size, size, 3), dtype=np.uint8)
            alpha = rng.randint(0, 256, (size, size), dtype=np.uint8)
            if kind == "rgba":
                cv2.imwrite(path, np.concatenate([rgb, alpha[..., None]], -1))
            else:
                cv2.imwrite(path, rgb)
                mask = (alpha / 255.0).astype(np.float32)
                np.save(path.replace(".png", "_mask.npy"),
                        mask if f % 2 == 0 else mask[..., None])


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    rng = np.random.RandomState(0)
    listed = str(tmp_path_factory.mktemp("listed"))
    _write_motion(listed, "walk", "rgba", rng, 48)       # resized to 32
    _write_motion(listed, "wave", "rgb", rng, REF)
    with_info = str(tmp_path_factory.mktemp("with_info"))
    _write_motion(with_info, "jump", "rgb", rng, 40)
    info = {"azimuths_deg": [0.0, 180.0], "elevations_deg": [0.0, 10.0],
            "full_azimuths_deg": [0.0, 120.0, 240.0],
            "input_videos": ["jump"]}
    with open(os.path.join(with_info, "info.json"), "w") as f:
        json.dump(info, f)
    no_list = str(tmp_path_factory.mktemp("no_list"))
    with open(os.path.join(no_list, "info.json"), "w") as f:
        json.dump({k: v for k, v in info.items() if k != "input_videos"}, f)
    bare = str(tmp_path_factory.mktemp("bare"))
    _write_motion(bare, "nomask", "rgb", rng, REF)
    os.remove(os.path.join(bare, "nomask", "view_00", "00_mask.npy"))
    return {"listed": listed, "with_info": with_info, "no_list": no_list,
            "bare": bare}


@pytest.mark.parametrize("which,videos", [
    ("listed", None), ("listed", "wave,walk"), ("listed", ["walk"]),
    ("with_info", None), ("with_info", "jump"), ("no_list", "jump")])
def test_load_info_matches_jax(folders, which, videos):
    args = (folders[which], VIEWS, FRAMES, 5.0, videos)
    assert tds.load_info(*args) == jds.load_info(*args)


def test_load_info_refusals_match_jax(folders):
    args = (folders["no_list"], VIEWS, FRAMES, 0.0, None)
    for load in (jds.load_info, tds.load_info):
        with pytest.raises(ValueError, match="Input videos"):
            load(*args)
    # three views against an info.json of two: the reference asserts, the
    # port raises ValueError (outside input is validated by a raise)
    args = (folders["with_info"], 3, FRAMES, 0.0, None)
    with pytest.raises(AssertionError):
        jds.load_info(*args)
    with pytest.raises(ValueError, match="azimuths"):
        tds.load_info(*args)


@pytest.mark.parametrize("which", ["listed", "with_info"])
def test_load_videos_match_jax(folders, which):
    meta = tds.load_info(folders[which], VIEWS, FRAMES, 0.0, None)
    args = (folders[which], meta["input_videos"], VIEWS, FRAMES, REF)
    got, ref = tds.load_videos(*args, workers=3), jds.load_videos(*args)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.uint8 and g.shape == r.shape
        assert np.array_equal(g, r)
    images, masks = got
    assert images.shape == (len(meta["input_videos"]), VIEWS, FRAMES, REF,
                            REF, 3)
    assert masks.std() > 10 and images.std() > 10


def test_load_frame_matches_jax(folders):
    """One frame of each kind, and the frame with neither alpha nor mask."""
    for name, size in (("walk", REF), ("wave", 24)):
        path = os.path.join(folders["listed"], name, "view_01", "02.png")
        for g, r in zip(tds._load_frame(path, size),
                        jds._load_frame(path, size)):
            assert np.array_equal(g, r), name
    path = os.path.join(folders["bare"], "nomask", "view_00", "00.png")
    for load in (jds._load_frame, tds._load_frame):
        with pytest.raises(FileNotFoundError, match="no cached mask"):
            load(path, REF)
        with pytest.raises(FileNotFoundError):
            load(path.replace("00.png", "99.png"), REF)


def _fields_equal(got, ref):
    assert type(got).__name__ == type(ref).__name__
    for name in ref._fields:
        g, r = getattr(got, name), getattr(ref, name)
        if isinstance(r, np.ndarray) or isinstance(r, np.generic):
            assert np.asarray(g).dtype == np.asarray(r).dtype, name
            assert np.array_equal(g, r), name
        else:
            assert g == r, name


def test_colmap_helpers_match_jax():
    rng = np.random.RandomState(1)
    for fov, px in ((0.6, 512), (1.1, 800), (0.25, 33)):
        assert tcol.fov2focal(fov, px) == jcol.fov2focal(fov, px)
        f = jcol.fov2focal(fov, px)
        assert tcol.focal2fov(f, px) == jcol.focal2fov(f, px)
    infos_t, infos_j = [], []
    for uid in range(4):
        q, _ = np.linalg.qr(rng.randn(3, 3))
        R, T = q.astype(np.float32), rng.randn(3).astype(np.float32)
        for kw in ({}, {"translate": rng.randn(3).astype(np.float32)},
                   {"scale": 1.7}, {"translate": np.ones(3), "scale": 0.5}):
            a, b = tcol.get_world2view(R, T, **kw), jcol.get_world2view(R, T, **kw)
            assert a.dtype == b.dtype and np.array_equal(a, b), kw
        args = (uid, R, T, 0.7, 0.5, 64, 48, f"img{uid}.png", f"img{uid}")
        infos_t.append(tcol.CameraInfo(*args))
        infos_j.append(jcol.CameraInfo(*args))
        _fields_equal(infos_t[-1], infos_j[-1])
    a, b = tcol.get_nerfpp_norm(infos_t), jcol.get_nerfpp_norm(infos_j)
    assert a.keys() == b.keys() and a["radius"] == b["radius"]
    assert np.array_equal(a["translate"], b["translate"])
    for kw in ({"n": 5}, {"n": 3, "radius": 2.5, "elevation": -20.0}):
        for x, y in zip(tcol.uniform_orbit_poses(**kw),
                        jcol.uniform_orbit_poses(**kw)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    for orbit in (True, False):
        got = tcol.video_nvs_cameras(4, 64, 48, 0.8, radius=2.2,
                                     elevation=15.0, orbit=orbit)
        ref = jcol.video_nvs_cameras(4, 64, 48, 0.8, radius=2.2,
                                     elevation=15.0, orbit=orbit)
        assert len(got) == len(ref) == 4
        for g, r in zip(got, ref):
            _fields_equal(g, r)


@pytest.mark.parametrize("size", [(64, 64), (800, 576), (33, 17)])
def test_camera_from_intrinsics_matches_jax(size):
    w, h = size
    rng = np.random.RandomState(w + h)
    K = np.array([[rng.uniform(0.5, 2) * w, 0, rng.uniform(0.3, 0.7) * w],
                  [0, rng.uniform(0.5, 2) * h, rng.uniform(0.3, 0.7) * h],
                  [0, 0, 1]], np.float32)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3], w2c[:3, 3] = q, rng.randn(3)
    for kw in ({}, {"znear": 0.1, "zfar": 20.0}):
        _fields_equal(tcams.Camera.from_intrinsics(K, w2c, w, h, **kw),
                      jcams.Camera.from_intrinsics(K, w2c, w, h, **kw))
