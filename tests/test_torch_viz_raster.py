"""The port's 3-D track video without matplotlib
(`dimo_tpu_torch.viz._plot_3d_tracks_raster`) against the JAX package's
matplotlib figure (`dimo_tpu.viz.plot_3d_tracks`), on the CPU.

Tracks come from a numpy seed: N = 24 random walks over F frames in 3-D.
Cases: F = 5 with and without `visibles`, at figsize (2, 2) and (5, 5);
F = 1 (no trailing segments); one axis of zero extent, at 0.25 and at 0
(matplotlib widens equal limits by 5 % of their value, to +-0.05 at 0).

What each case holds, and what was measured (matplotlib 3.10.8,
OpenCV 5.0.0, on the CPU):
  * the shapes are equal;
  * projection: every visible current point lies where matplotlib puts it
    (`ax.get_proj()`, `proj3d.proj_transform`, `transData`, y flipped)
    within 0.5 px; measured at most 5.1e-13 px;
  * ink (any channel < 250): at least 99 % of each image's ink pixels lie
    within 1 px of the other image's ink; measured 100 % both ways in
    every case;
  * background: every pixel farther than 1 px from the ink of both
    images is pure white in both. Antialiasing leaves a fringe of 250-254
    next to the ink in both images (e.g. 261 such pixels in
    matplotlib's 24-track video, 310 in the raster's), none beyond 1 px;
  * colour: at each current point that matplotlib draws on top (no later
    marker within 5 px), the pixel Agg centres the marker on is within
    16 LSB of matplotlib's in every channel; measured 0 (both draw the
    exact jet colour there).
"""
import sys
import warnings

import numpy as np
import pytest
from scipy.ndimage import binary_dilation

from dimo_tpu import viz as jviz

from dimo_tpu_torch import viz as tviz

N = 24
INK = 250
NEAR = np.ones((3, 3), bool)               # within 1 px, diagonals too
PROJ_TOL, INK_SHARE, COLOUR_TOL, ON_TOP_PX = 0.5, 0.99, 16, 5.0


def make_tracks(f, flat=None, seed=0):
    rng = np.random.RandomState(seed)
    start = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    steps = rng.normal(0, 0.05, (f, N, 3)).astype(np.float32)
    tracks = start[None] + np.cumsum(steps, 0)
    if flat is not None:                       # (axis, value)
        tracks[..., flat[0]] = flat[1]
    return tracks


def mpl_points(tracks, figsize):
    """matplotlib's own (col, row, depth) of every point, each (F, N), in
    the figure `jviz.plot_3d_tracks` builds."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from mpl_toolkits.mplot3d import proj3d
    mins = tracks.reshape(-1, 3).min(0)
    maxs = tracks.reshape(-1, 3).max(0)
    fig = plt.figure(figsize=figsize)
    ax = fig.add_subplot(projection="3d")
    with warnings.catch_warnings():        # equal limits warn, then widen
        warnings.simplefilter("ignore")
        ax.set_xlim(mins[0], maxs[0])
        ax.set_ylim(mins[1], maxs[1])
        ax.set_zlim(mins[2], maxs[2])
    ax.set_axis_off()
    fig.canvas.draw()
    flat = tracks.reshape(-1, 3)
    x, y, z = proj3d.proj_transform(flat[:, 0], flat[:, 1], flat[:, 2],
                                    ax.get_proj())
    disp = ax.transData.transform(np.stack([x, y], -1))
    height = fig.canvas.get_width_height()[1]
    plt.close(fig)
    shape = tracks.shape[:2]
    return (disp[:, 0].reshape(shape), (height - disp[:, 1]).reshape(shape),
            np.asarray(z).reshape(shape))


CASES = {
    "f5-all-5x5": dict(f=5, vis=False, figsize=(5, 5)),
    "f5-vis-5x5": dict(f=5, vis=True, figsize=(5, 5)),
    "f5-all-2x2": dict(f=5, vis=False, figsize=(2, 2)),
    "f5-vis-2x2": dict(f=5, vis=True, figsize=(2, 2)),
    "f1": dict(f=1, vis=False, figsize=(5, 5)),
    "flat-z": dict(f=5, vis=True, figsize=(5, 5), flat=(2, 0.25)),
    "flat-x-at-0": dict(f=5, vis=False, figsize=(2, 2), flat=(0, 0.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_raster_matches_matplotlib(case):
    c = CASES[case]
    tracks = make_tracks(c["f"], c.get("flat"))
    vis = (np.random.RandomState(4).rand(c["f"], N) > 0.3) if c["vis"] \
        else None
    ref = jviz.plot_3d_tracks(tracks, vis, 8, c["figsize"])
    got = tviz._plot_3d_tracks_raster(tracks, vis, 8, c["figsize"])
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape
    assert got.shape == (c["f"], c["figsize"][1] * 100, c["figsize"][0] * 100,
                         3)

    col, row, depth = mpl_points(tracks, c["figsize"])
    t_col, t_row, _ = tviz._project_3d_tracks(tracks, c["figsize"])
    if vis is None:
        vis = np.ones((c["f"], N), bool)
    err = max(np.abs(t_col - col)[vis].max(), np.abs(t_row - row)[vis].max())
    assert err <= PROJ_TOL, f"projection off by {err} px"

    for fi, (g, r) in enumerate(zip(got, ref)):
        ink_g, ink_r = (g < INK).any(-1), (r < INK).any(-1)
        assert ink_g.any() and ink_r.any(), f"frame {fi}: no ink"
        near_g, near_r = binary_dilation(ink_g, NEAR), binary_dilation(ink_r,
                                                                      NEAR)
        share_g = (ink_g & near_r).sum() / ink_g.sum()
        share_r = (ink_r & near_g).sum() / ink_r.sum()
        assert min(share_g, share_r) >= INK_SHARE, \
            f"frame {fi}: ink within 1 px {share_g:.4f} / {share_r:.4f}"
        far = ~(near_g | near_r)
        assert (g[far] == 255).all() and (r[far] == 255).all(), \
            f"frame {fi}: a pixel beyond 1 px of all ink is not white"

        # the current points matplotlib draws on top: farthest first, so a
        # point is on top when no point drawn after it lies within 5 px
        idx = np.flatnonzero(vis[fi])
        order = idx[np.argsort(-depth[fi, idx], kind="stable")]
        at = np.stack([np.floor(col[fi] + 0.5), np.floor(row[fi] + 0.5)], -1)
        checked = 0
        for k, i in enumerate(order):
            later = order[k + 1:]
            if len(later) and np.hypot(*(at[later] - at[i]).T).min() \
                    < ON_TOP_PX:
                continue
            x, y = at[i].astype(int)
            diff = np.abs(g[y, x].astype(int) - r[y, x].astype(int)).max()
            assert diff <= COLOUR_TOL, \
                f"frame {fi} track {i}: colour {g[y, x]} vs {r[y, x]}"
            checked += 1
        assert checked > 0


def test_plot_3d_tracks_without_matplotlib(monkeypatch):
    """Where matplotlib does not import, `plot_3d_tracks` is the raster
    route, and that route imports no matplotlib."""
    tracks = make_tracks(5)
    vis = np.random.RandomState(4).rand(5, N) > 0.3
    want = tviz._plot_3d_tracks_raster(tracks, vis, 3, (2, 2))
    for name in [m for m in sys.modules
                 if m == "matplotlib" or m.startswith(("matplotlib.",
                                                       "mpl_toolkits"))]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "mpl_toolkits", None)
    got = tviz.plot_3d_tracks(tracks, vis, tracks_leave_trace=3,
                              figsize=(2, 2))
    assert np.array_equal(got, want)
    assert np.array_equal(tviz._plot_3d_tracks_raster(tracks, vis, 3, (2, 2)),
                          want)
    assert not [m for m in sys.modules
                if m.startswith(("matplotlib.", "mpl_toolkits."))]


def test_write_video_gif_through_pil(tmp_path, monkeypatch):
    """The last resort without imageio (absent on the card's machine) and
    with no OpenCV writer: a GIF through PIL, at the name imageio's would
    have, holding every frame (a few colours, so the palette is exact)."""
    import cv2
    from PIL import Image

    class Closed:
        def __init__(self, *a):
            pass

        def isOpened(self):
            return False

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setattr(cv2, "VideoWriter", Closed)
    rng = np.random.RandomState(5)
    palette = np.array([[255, 255, 255], [0, 0, 127], [255, 0, 0],
                        [12, 200, 40]], np.uint8)
    frames = list(palette[rng.randint(0, 4, (4, 24, 32))])
    frames.append(np.full((24, 32), 90, np.uint8))           # a 2-D frame
    tviz.write_video(str(tmp_path / "sub" / "clip.mp4"), frames, fps=5)
    assert sorted(p.name for p in (tmp_path / "sub").iterdir()) == ["clip.gif"]
    with Image.open(tmp_path / "sub" / "clip.gif") as im:
        assert im.n_frames == len(frames) and im.size == (32, 24)
        for i, want in enumerate(frames):
            im.seek(i)
            got = np.asarray(im.convert("RGB"))
            if want.ndim == 2:
                want = np.repeat(want[..., None], 3, -1)
            assert np.array_equal(got, want), f"frame {i}"
