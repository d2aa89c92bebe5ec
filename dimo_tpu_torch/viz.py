"""Visualization/export: trajectory overlays, 3D track plots, video writing.

Copy of `dimo_tpu/viz.py` (the reference's `utils/vis_utils.py` +
`src/helpers.py:142-241` track rendering and the top-level imageio/cv2
export calls). numpy on the host: callers pass numpy arrays (the test
modes copy frames and points off the device first). Libraries are
imported inside the functions that use them, and each route says which
it needs:

  * the track colours (`_colormap_jet`) are matplotlib's "jet" computed
    with numpy, and `project_points` / `interactive_3d_html` are numpy;
  * `trajectory_image`, `trajectory_frames` and `plot_2d_tracks` draw
    with OpenCV;
  * `plot_3d_tracks` draws with matplotlib where it imports, as the
    reference does, and otherwise through `_plot_3d_tracks_raster`:
    mplot3d's default view recomputed with numpy, drawn with OpenCV;
  * `write_video` writes an mp4 through imageio, else through OpenCV, and
    as a last resort a GIF through imageio, or through PIL where imageio
    does not import.
"""
from __future__ import annotations

import os

import numpy as np


# matplotlib's "jet" (`matplotlib._cm._jet_data`): per channel, (x, y0, y1)
# breakpoints of a piecewise-linear map, sampled into a 256-entry table
_JET = {"red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
                (1.0, 0.5, 0.5)),
        "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1),
                  (0.91, 0, 0), (1.0, 0, 0)),
        "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
                 (1.0, 0, 0))}
_LUT_N = 256


def _jet_lut() -> np.ndarray:
    """(256, 3) float64 table, as `matplotlib.colors._create_lookup_table`
    builds it for a LinearSegmentedColormap."""
    n = _LUT_N
    chans = []
    for name in ("red", "green", "blue"):
        a = np.array(_JET[name], dtype=float)
        x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
        xind = (n - 1) * np.linspace(0, 1, n)
        ind = np.searchsorted(x, xind)[1:-1]
        distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
        lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1])
                              + y1[ind - 1], [y0[-1]]])
        chans.append(np.clip(lut, 0.0, 1.0))
    return np.stack(chans, axis=-1)


def _colormap_jet(n: int) -> np.ndarray:
    """(n, 3) int32 colours spread over "jet", the reference's
    `matplotlib.colormaps["jet"](i / (n - 1))[:3] * 255` without
    matplotlib (absent where the card is): a float x picks table row
    int(x * 256), 255 for x = 1."""
    lut = _jet_lut()
    rows = [min(int(i / max(1, float(n - 1)) * _LUT_N), _LUT_N - 1)
            for i in range(n)]
    return np.array([lut[r] * 255 for r in rows], dtype=np.int32)


def project_points(pts3d: np.ndarray, full_proj: np.ndarray,
                   width: int, height: int) -> np.ndarray:
    """(N,3) world points -> (N,2) pixel coords via the transposed full-proj
    (reference `main_train_dimo.py:675-679`)."""
    hom = np.concatenate([pts3d, np.ones_like(pts3d[:, :1])], axis=-1)
    clip = hom @ np.asarray(full_proj)
    xy = clip[:, :2] / clip[:, 3:4]
    return (xy + 1.0) / 2.0 * np.array([width, height], np.float32)


def trajectory_image(traj_pts: np.ndarray, width: int, height: int,
                     thickness: int = 1):
    """Full-trajectory polyline image (reference `main_train_dimo.py:691-703`).
    traj_pts: (N, F, 2). Returns (rgb_img, alpha_img) float arrays in [0,1]."""
    import cv2
    n = traj_pts.shape[0]
    colors = _colormap_jet(n)
    alpha_img = np.zeros([height, width, 3])
    traj_img = np.zeros([height, width, 3])
    for i in range(n):
        pts = [traj_pts[i].astype(np.int32)]
        alpha_img = cv2.polylines(alpha_img, pts, False, [1, 1, 1], thickness)
        col = colors[i] / 255
        traj_img = cv2.polylines(traj_img, pts, False,
                                 [float(col[0]), float(col[1]), float(col[2])],
                                 thickness)
    return traj_img, alpha_img


def trajectory_frames(traj_pts: np.ndarray, width: int, height: int):
    """Per-frame growing-trace overlays (reference `:718-727`).
    traj_pts: (N, F, 2) -> list of F uint8 images."""
    import cv2
    n, f, _ = traj_pts.shape
    colors = _colormap_jet(n)
    frames = []
    for fi in range(f):
        img = np.zeros([height, width, 3])
        for i in range(n):
            col = colors[i] / 255
            c = [float(col[0]), float(col[1]), float(col[2])]
            img = cv2.polylines(img, [traj_pts[i, :fi + 1].astype(np.int32)],
                                False, c, 2)
            img = cv2.circle(img, tuple(traj_pts[i, fi].astype(np.int32)), 2,
                             c, -1, lineType=cv2.LINE_AA)
        frames.append((img * 255).astype(np.uint8))
    return frames


def plot_2d_tracks(frames: np.ndarray, tracks: np.ndarray,
                   visibles: np.ndarray | None = None,
                   tracks_leave_trace: int = 8) -> np.ndarray:
    """2D point-track overlay video (reference `utils/vis_utils.py:30-79`).
    frames: (F, H, W, 3) u8; tracks: (F, N, 2) pixel coords.
    Returns (F, H, W, 3) u8 with colored traces drawn on the frames."""
    import cv2
    f, n, _ = tracks.shape
    if visibles is None:
        visibles = np.ones((f, n), bool)
    colors = _colormap_jet(n)
    out = []
    for fi in range(f):
        img = frames[fi].copy()
        start = max(0, fi - tracks_leave_trace)
        for i in range(n):
            if not visibles[fi, i]:
                continue
            col = colors[i].tolist()
            seg = tracks[start:fi + 1, i].astype(np.int32)
            if len(seg) > 1:
                img = cv2.polylines(img, [seg], False, col, 1,
                                    lineType=cv2.LINE_AA)
            img = cv2.circle(img, tuple(seg[-1]), 2, col, -1,
                             lineType=cv2.LINE_AA)
        out.append(img)
    return np.stack(out)


def plot_3d_tracks(tracks: np.ndarray, visibles: np.ndarray | None = None,
                   tracks_leave_trace: int = 8, figsize=(5, 5)) -> np.ndarray:
    """Matplotlib 3D track video (reference `utils/vis_utils.py:259-314`).
    tracks: (F, N, 3) -> (F, H, W, 3) uint8. Without matplotlib, the same
    figure through `_plot_3d_tracks_raster`."""
    try:
        import matplotlib
    except ImportError:
        return _plot_3d_tracks_raster(tracks, visibles, tracks_leave_trace,
                                      figsize)
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    f, n, _ = tracks.shape
    if visibles is None:
        visibles = np.ones((f, n), bool)
    colors = _colormap_jet(n) / 255.0

    mins = tracks.reshape(-1, 3).min(0)
    maxs = tracks.reshape(-1, 3).max(0)
    frames = []
    for fi in range(f):
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(projection="3d")
        ax.set_xlim(mins[0], maxs[0])
        ax.set_ylim(mins[1], maxs[1])
        ax.set_zlim(mins[2], maxs[2])
        start = max(0, fi - tracks_leave_trace)
        for i in range(n):
            if visibles[fi, i]:
                seg = tracks[start:fi + 1, i]
                ax.plot(seg[:, 0], seg[:, 1], seg[:, 2],
                        color=colors[i], linewidth=1)
                ax.scatter(*tracks[fi, i], color=colors[i], s=3)
        ax.set_axis_off()
        fig.canvas.draw()
        buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
        w, h = fig.canvas.get_width_height()
        frames.append(buf.reshape(h, w, 4)[..., :3].copy())
        plt.close(fig)
    return np.stack(frames)


# The figure `plot_3d_tracks` draws with matplotlib (3.10's
# `mpl_toolkits/mplot3d/axes3d.py`, `proj3d.py` and `art3d.py`): the
# default figure dpi and subplot box, one Axes3D at its default view
# (elev 30, azim -60, roll 0, perspective, focal length 1, distance 10,
# box aspect 4:4:3), whose 2-D view limits are (-0.95, 0.9) / distance.
_DPI = 100.0
_SUBPLOT = (0.125, 0.11, 0.9, 0.88)            # left, bottom, right, top
_ELEV, _AZIM, _DIST, _FOCAL = 30.0, -60.0, 10.0, 1.0
_BOX = (np.array([4.0, 4.0, 3.0]) * 1.8294640721620434 * 25 / 24
        / np.linalg.norm([4.0, 4.0, 3.0]))
_VIEW = (-0.95 / _DIST, 0.9 / _DIST)
# `ax.scatter(..., s=3)`'s radius in pixels: a marker of diameter sqrt(3)
# pt with a 1 pt edge of its own colour
_MARKER_R_PX = (np.sqrt(3.0) / 2 + 0.5) * _DPI / 72.0
_SHIFT = 4                                     # OpenCV's fractional bits


def _nonsingular(lo: float, hi: float, expander: float = 0.05,
                 tiny: float = 1e-15) -> tuple[float, float]:
    """matplotlib's widening of equal axis limits
    (`transforms.nonsingular` with the tick locator's expander 0.05)."""
    lo, hi = float(lo), float(hi)
    if hi - lo <= max(abs(lo), abs(hi)) * tiny:
        if hi == 0 and lo == 0:
            return -expander, expander
        return lo - expander * abs(lo), hi + expander * abs(hi)
    return lo, hi


def _mplot3d_proj(lims) -> np.ndarray:
    """(4, 4) `Axes3D.get_proj()` at the default view for axis limits
    ((x0, x1), (y0, y1), (z0, z1)): world box, look-at, perspective."""
    span = np.array([hi - lo for lo, hi in lims]) / _BOX
    world = np.eye(4)
    world[:3, :3] = np.diag(1.0 / span)
    world[:3, 3] = [-lo / d for (lo, _), d in zip(lims, span)]
    centre = 0.5 * _BOX
    e, a = np.deg2rad(_ELEV), np.deg2rad(_AZIM)
    ps = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    w = ps / np.linalg.norm(ps)                # out of the screen
    u = np.cross([0.0, 0.0, 1.0], w)
    u /= np.linalg.norm(u)                     # to the right
    v = np.cross(w, u)                         # up
    rot, move = np.eye(4), np.eye(4)
    rot[:3, :3] = [u, v, w]
    move[:3, 3] = -(centre + _DIST * ps * _FOCAL)
    near, far = -_DIST, _DIST
    persp = np.array([[_FOCAL, 0, 0, 0], [0, _FOCAL, 0, 0],
                      [0, 0, (near + far) / (near - far),
                       -2 * near * far / (near - far)],
                      [0, 0, -1, 0]])
    return persp @ rot @ move @ world


def _axes_box(wpx: int, hpx: int) -> tuple[float, float, float, float]:
    """(x0, y0, width, height) in pixels, y up: the default subplot box
    made square and centred (`Axes3D.apply_aspect`)."""
    left, bottom, right, top = _SUBPLOT
    w, h = right - left, top - bottom
    fig_aspect = hpx / wpx
    bw, bh = w, w / fig_aspect
    if bh > h:
        bw, bh = h * fig_aspect, h
    return ((left + (w - bw) / 2) * wpx, (bottom + (h - bh) / 2) * hpx,
            bw * wpx, bh * hpx)


def _project_3d_tracks(tracks: np.ndarray, figsize=(5, 5)):
    """Where `plot_3d_tracks`' figure puts each point of (F, N, 3) tracks:
    (col, row, depth), each (F, N), in pixels from the top-left corner of
    the (H, W) image (a pixel's centre at +0.5) and in mplot3d's projected
    depth (larger is farther)."""
    wpx, hpx = int(round(figsize[0] * _DPI)), int(round(figsize[1] * _DPI))
    flat = np.asarray(tracks, np.float64).reshape(-1, 3)
    lims = [_nonsingular(lo, hi) for lo, hi in zip(flat.min(0), flat.max(0))]
    hom = np.concatenate([flat, np.ones_like(flat[:, :1])], 1)
    clip = hom @ _mplot3d_proj(lims).T
    ndc = clip[:, :3] / clip[:, 3:]
    x0, y0, bw, bh = _axes_box(wpx, hpx)
    scale = 1.0 / (_VIEW[1] - _VIEW[0])
    col = x0 + (ndc[:, 0] - _VIEW[0]) * scale * bw
    row = hpx - (y0 + (ndc[:, 1] - _VIEW[0]) * scale * bh)
    shape = np.shape(tracks)[:-1]
    return col.reshape(shape), row.reshape(shape), ndc[:, 2].reshape(shape)


def _plot_3d_tracks_raster(tracks: np.ndarray,
                           visibles: np.ndarray | None = None,
                           tracks_leave_trace: int = 8,
                           figsize=(5, 5)) -> np.ndarray:
    """`plot_3d_tracks`' figure without matplotlib: the points projected as
    mplot3d projects them (`_project_3d_tracks`), drawn with OpenCV's
    antialiased polylines and filled circles on white, in matplotlib's
    order: every visible track's trailing segment in track order (a
    one-point segment draws nothing; OpenCV's 1 px antialiased line stands
    for the 1 pt = 1.39 px one, its ink within a pixel of Agg's), then the
    current points farthest first (`computed_zorder` sorts the scatters,
    not the lines), each centred on the pixel Agg snaps a marker to, all
    clipped to the axes' box. tracks: (F, N, 3) -> (F, H, W, 3) uint8."""
    import cv2
    f, n, _ = tracks.shape
    if visibles is None:
        visibles = np.ones((f, n), bool)
    wpx, hpx = int(round(figsize[0] * _DPI)), int(round(figsize[1] * _DPI))
    col, row, depth = _project_3d_tracks(tracks, figsize)
    one = 1 << _SHIFT
    # OpenCV puts a pixel's centre at its integer coordinate, Agg at +0.5
    pts = np.round(np.stack([col - 0.5, row - 0.5], -1) * one).astype(np.int32)
    dots = np.stack([np.floor(col + 0.5), np.floor(row + 0.5)],
                    -1).astype(np.int32) * one
    radius = int(round(_MARKER_R_PX * one))
    colors = [tuple(int(c) for c in rgb) for rgb in _colormap_jet(n)]
    x0, y0, bw, bh = _axes_box(wpx, hpx)
    c0, c1 = int(np.floor(x0 + 0.5)), int(np.floor(x0 + bw + 0.5))
    r0, r1 = int(np.floor(hpx - y0 - bh + 0.5)), int(np.floor(hpx - y0 + 0.5))
    frames = np.full((f, hpx, wpx, 3), 255, np.uint8)
    for fi in range(f):
        img = frames[fi]
        start = max(0, fi - tracks_leave_trace)
        vis = np.flatnonzero(visibles[fi])
        if fi > start:
            for i in vis:
                seg = np.ascontiguousarray(pts[start:fi + 1, i])
                cv2.polylines(img, [seg], False, colors[i], 1, cv2.LINE_AA,
                              _SHIFT)
        for i in vis[np.argsort(-depth[fi, vis], kind="stable")]:
            cv2.circle(img, (int(dots[fi, i, 0]), int(dots[fi, i, 1])), radius,
                       colors[i], -1, cv2.LINE_AA, _SHIFT)
        img[:r0], img[r1:], img[:, :c0], img[:, c1:] = 255, 255, 255, 255
    return frames


def interactive_3d_html(tracks: np.ndarray, point_size: float = 2.5,
                        trace: int = 8) -> str:
    """Self-contained interactive 3D trajectory viewer (HTML string).

    Replacement for the reference's scenepic export
    (`utils/vis_utils.py:106-256`, get_interactive_3d_visualization) with
    zero external dependencies: vanilla-JS canvas renderer with orbit
    controls and frame playback. tracks: (F, N, 3).
    """
    import json
    f, n, _ = tracks.shape
    colors = _colormap_jet(n).tolist()
    center = tracks.reshape(-1, 3).mean(0)
    scale = float(np.abs(tracks.reshape(-1, 3) - center).max() + 1e-6)
    norm = ((tracks - center) / scale).astype(np.float32)
    data = json.dumps(np.round(norm, 4).tolist())
    cols = json.dumps(colors)
    return f"""<!DOCTYPE html><html><head><meta charset="utf-8">
<title>DIMO-TPU 3D trajectories</title>
<style>body{{margin:0;background:#111;color:#eee;font-family:monospace}}
#c{{display:block}} #hud{{position:fixed;top:8px;left:8px}}</style></head>
<body><canvas id="c"></canvas><div id="hud">frame <span id="fr">0</span>/{f - 1}
&nbsp; drag: orbit &nbsp; wheel: zoom &nbsp; space: pause</div>
<script>
const T={data}, C={cols}, F={f}, N={n}, TRACE={trace}, PS={point_size};
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let W,H;function rs(){{W=cv.width=innerWidth;H=cv.height=innerHeight;}}
rs();addEventListener('resize',rs);
let az=0.6,el=0.4,zoom=Math.min(innerWidth,innerHeight)*0.35,fi=0,run=true;
let dragging=false,lx=0,ly=0;
cv.onmousedown=e=>{{dragging=true;lx=e.clientX;ly=e.clientY}};
addEventListener('mouseup',()=>dragging=false);
addEventListener('mousemove',e=>{{if(!dragging)return;
az+=(e.clientX-lx)*0.01;el+=(e.clientY-ly)*0.01;lx=e.clientX;ly=e.clientY}});
addEventListener('wheel',e=>zoom*=Math.pow(1.1,-Math.sign(e.deltaY)));
addEventListener('keydown',e=>{{if(e.code==='Space')run=!run}});
function proj(p){{
 const ca=Math.cos(az),sa=Math.sin(az),ce=Math.cos(el),se=Math.sin(el);
 const x=p[0]*ca+p[2]*sa, z=-p[0]*sa+p[2]*ca;
 const y=p[1]*ce-z*se, zz=p[1]*se+z*ce;
 const d=3/(3+zz);
 return [W/2+x*zoom*d, H/2-y*zoom*d, d];}}
function draw(){{
 ctx.fillStyle='#111';ctx.fillRect(0,0,W,H);
 const s=Math.max(0,fi-TRACE);
 for(let i=0;i<N;i++){{
  const col=C[i];ctx.strokeStyle=`rgb(${{col[0]}},${{col[1]}},${{col[2]}})`;
  ctx.beginPath();
  for(let t=s;t<=fi;t++){{const q=proj(T[t][i]);
   if(t===s)ctx.moveTo(q[0],q[1]);else ctx.lineTo(q[0],q[1]);}}
  ctx.stroke();
  const q=proj(T[fi][i]);
  ctx.fillStyle=ctx.strokeStyle;
  ctx.beginPath();ctx.arc(q[0],q[1],PS*q[2],0,6.3);ctx.fill();}}
 document.getElementById('fr').textContent=fi;}}
setInterval(()=>{{if(run)fi=(fi+1)%F;draw();}},125);
</script></body></html>"""


def write_video(path: str, frames, fps: int = 8) -> None:
    """mp4 via imageio-ffmpeg when available, else cv2's bundled codec
    (this image ships no ffmpeg plugin), else a .gif fallback: imageio's,
    or PIL's where imageio does not import."""
    frames = [np.asarray(f) for f in frames]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        import imageio
        imageio.mimwrite(path, frames, fps=fps, quality=8, macro_block_size=1)
        return
    except Exception:
        pass
    try:
        import cv2
        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if vw.isOpened():
            for f in frames:
                if f.ndim == 2:
                    f = np.repeat(f[..., None], 3, -1)
                vw.write(f[..., ::-1])  # RGB -> BGR
            vw.release()
            return
    except Exception:
        pass
    gif = os.path.splitext(path)[0] + ".gif"
    try:
        import imageio
    except ImportError:
        from PIL import Image
        imgs = [Image.fromarray(f).convert("RGB") for f in frames]
        imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                     duration=1000.0 / fps, loop=0)
        return
    imageio.mimwrite(gif, frames, duration=1000.0 / fps)
