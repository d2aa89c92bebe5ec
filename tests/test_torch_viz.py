"""The port's `viz.py` against the JAX package's, on the CPU.

Inputs, the same for both packages, from a numpy seed: 24 control-point
tracks over 5 frames in 3-D, their projection through a port `Camera`,
and 5 random 64x48 uint8 frames for the 2-D overlay.

Tolerances: `project_points` within float32 rounding (1e-6 relative;
the code is numpy in both). Everything else must be equal: the colour
table (the port computes matplotlib's "jet" with numpy, for the card's
machine, which has no matplotlib), the OpenCV polylines and circles, the
matplotlib 3-D frames, the HTML string, and `write_video`'s file name and
route on each of its three routes (imageio, OpenCV, the GIF fallback).
"""
import os

import numpy as np
import pytest

from dimo_tpu import viz as jviz

from dimo_tpu_torch import viz as tviz
from dimo_tpu_torch.utils import cameras as tcams

W, H, N, F = 64, 48, 24, 5


@pytest.fixture(scope="module")
def tracks():
    rng = np.random.RandomState(0)
    start = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    steps = rng.normal(0, 0.05, (F, N, 3)).astype(np.float32)
    pts3d = start[None] + np.cumsum(steps, 0)                 # (F, N, 3)
    cam = tcams.Camera.from_c2w(tcams.orbit_camera(10.0, 30.0, 2.0),
                                0.9, 0.7)
    traj = np.stack([jviz.project_points(p, cam.full_proj, W, H)
                     for p in pts3d], axis=1)                 # (N, F, 2)
    frames = rng.randint(0, 256, (F, H, W, 3)).astype(np.uint8)
    return {"pts3d": pts3d, "cam": cam, "traj": traj, "frames": frames}


@pytest.mark.parametrize("n", [1, 2, 24, 512, 1000])
def test_colormap_matches_matplotlib_jet(n):
    got, ref = tviz._colormap_jet(n), jviz._colormap_jet(n)
    assert got.dtype == ref.dtype == np.int32 and np.array_equal(got, ref)


def test_project_points_matches_jax(tracks):
    for p in tracks["pts3d"]:
        got = tviz.project_points(p, tracks["cam"].full_proj, W, H)
        ref = jviz.project_points(p, tracks["cam"].full_proj, W, H)
        assert got.shape == (N, 2)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("thickness", [1, 2])
def test_trajectory_image_matches_jax(tracks, thickness):
    got = tviz.trajectory_image(tracks["traj"], W, H, thickness)
    ref = jviz.trajectory_image(tracks["traj"], W, H, thickness)
    for g, r in zip(got, ref):
        assert g.shape == (H, W, 3) and np.array_equal(g, r)
    assert ref[1].sum() > 0


def test_trajectory_frames_match_jax(tracks):
    got = tviz.trajectory_frames(tracks["traj"], W, H)
    ref = jviz.trajectory_frames(tracks["traj"], W, H)
    assert len(got) == len(ref) == F
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.uint8 and np.array_equal(g, r)


@pytest.mark.parametrize("trace", [2, 8])
def test_plot_2d_tracks_matches_jax(tracks, trace):
    pix = tracks["traj"].transpose(1, 0, 2)                   # (F, N, 2)
    vis = np.random.RandomState(3).rand(F, N) > 0.2
    for visibles in (None, vis):
        got = tviz.plot_2d_tracks(tracks["frames"], pix, visibles, trace)
        ref = jviz.plot_2d_tracks(tracks["frames"], pix, visibles, trace)
        assert got.shape == (F, H, W, 3) and np.array_equal(got, ref)


def test_plot_3d_tracks_matches_jax(tracks):
    vis = np.random.RandomState(4).rand(F, N) > 0.3
    got = tviz.plot_3d_tracks(tracks["pts3d"], vis, tracks_leave_trace=3,
                              figsize=(2, 2))
    ref = jviz.plot_3d_tracks(tracks["pts3d"], vis, tracks_leave_trace=3,
                              figsize=(2, 2))
    assert got.shape == ref.shape and got.shape[0] == F
    assert np.array_equal(got, ref)


def test_interactive_html_matches_jax(tracks):
    for kw in ({}, {"point_size": 4.0, "trace": 2}):
        got = tviz.interactive_3d_html(tracks["pts3d"], **kw)
        assert got == jviz.interactive_3d_html(tracks["pts3d"], **kw)
    assert got.startswith("<!DOCTYPE html>")


@pytest.mark.parametrize("route", ["imageio", "cv2", "gif"])
def test_write_video_same_file_and_route(tracks, tmp_path, monkeypatch,
                                         route):
    """Spies on imageio.mimwrite and cv2.VideoWriter force each route and
    record which calls ran; both packages import the two lazily, so the
    spies see both."""
    import cv2
    import imageio
    calls = []
    real_writer = cv2.VideoWriter

    def mimwrite(path, frames, **kw):
        calls.append(("imageio", os.path.basename(path), len(frames)))
        if route == "cv2" or (route == "gif" and not path.endswith(".gif")):
            raise RuntimeError("no mp4 plugin")

    class Writer:
        def __init__(self, path, *a):
            calls.append(("cv2", os.path.basename(path)))
            self.inner = real_writer(path, *a) if route == "cv2" else None

        def isOpened(self):
            return self.inner is not None and self.inner.isOpened()

        def write(self, f):
            self.inner.write(f)

        def release(self):
            self.inner.release()

    monkeypatch.setattr(imageio, "mimwrite", mimwrite)
    monkeypatch.setattr(cv2, "VideoWriter", Writer)
    frames = list(tracks["frames"]) + [tracks["frames"][0][..., 0]]   # + 2-D
    seen = {}
    for name, mod in (("jax", jviz), ("torch", tviz)):
        calls.clear()
        out = tmp_path / name / "sub"
        mod.write_video(str(out / "clip.mp4"), frames, fps=6)
        seen[name] = (list(calls), sorted(os.listdir(out)))
    assert seen["torch"] == seen["jax"]
    want = {"imageio": ["imageio"], "cv2": ["imageio", "cv2"],
            "gif": ["imageio", "cv2", "imageio"]}[route]
    assert [c[0] for c in seen["jax"][0]] == want
    if route == "cv2":
        decoded = []
        for name in ("jax", "torch"):
            cap = cv2.VideoCapture(str(tmp_path / name / "sub" / "clip.mp4"))
            ok, first = cap.read()
            cap.release()
            assert ok
            decoded.append(first)
        assert np.array_equal(decoded[0], decoded[1])
