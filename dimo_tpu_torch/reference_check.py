"""The port held against reference vectors that the JAX package wrote at
full width.

`tests/make_torch_reference.py` runs `dimo_tpu` on the CPU and writes
`tests/golden/torch_reference_{frame,vjp,step}.npz`. This module rebuilds
the same inputs from numpy seeds on any device, runs the port through its
entry points, and returns each difference beside its limit:

* frame: the flagship s2 frame that `bench_torch.py` renders (512^2,
  capacity 1024). The port's strip lists hold the reference's entries in
  the reference's places, except two list neighbours whose view depths
  lie within LIST_TIE_DEPTH may trade places (`list_rows`). Composited
  over the reference's lists, ch7's image, alpha, depth and normal and
  ch3's image pass `tests/torch_parity.py::assert_close_except_cut_flips`'s
  rule at `tests/test_torch_render.py`'s tolerances (`plane_diff`); over
  the port's own lists, its pixel count. `overflow` and `overflow_max`
  equal; at most RADII_DIFF_MAX of the `radii` apart; the moved control
  points within 1e-5; the KNN indices counted;
* vjp: the gradient of sum_f W_f * plane_f over the ch7 frame's four
  planes (W_f uniform in [0.5, 1.5] from a seed) to every leaf;
* step: one s2 step with LPIPS on (the seeded random VGG, lambda 1000),
  `scripts/bench_train.py`'s 4 x 2 x 2 batch at 512^2, at step 300 (every
  gate open), to the loss terms and the gradients, before Adam.

A gradient leaf over SKETCH_MIN_BYTES is stored as its L2 norm, its max
|.| and its projections onto SKETCH_DIM standard normal vectors drawn from
a seed both sides share; the relative L2 of the difference is read
through them (`grad_rows`). Smaller leaves are stored whole.

Inputs (nothing of them is stored): the scene is `scenes.flagship_numpy`'s
draws, with every TimeNet leaf and the latent codes drawn by numpy
(`timenet_numpy`: the reference's init scales, and the position and
rotation heads non-zero so the points move); the batch is
`scripts/bench_train.py`'s draws from RandomState(0), with guidance =
c_xyz + 0.01 N(0, 1) drawn after them where that script's is zero (so
the chamfer term has a target; `chip_smoke.py::train_batch`'s recipe).
The step's one draw from the state's RNG, ARAP's 8 times, is made by the
JAX package and stored, as `tests/test_torch_train_step.py` fixes it.

The files are written by `write_vectors` (fixed zip dates, so a second
run writes the same bytes) and read by `read_vectors`. This module
imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import json
import os
import zipfile
import zlib

import numpy as np
import torch

from dimo_tpu_torch.io.convert import _timenet_layers, params_from_numpy
from dimo_tpu_torch.models import gaussians as G
from dimo_tpu_torch.models.lpips import random_init_lpips
from dimo_tpu_torch.models.renderer import find_knn, render
from dimo_tpu_torch.models.timenet import DEPTH, SKIPS, WIDTH, input_dim
from dimo_tpu_torch.ops.rasterizer import strips
from dimo_tpu_torch.scenes import flagship_camera, flagship_numpy
from dimo_tpu_torch.train.step import LossConfig, init_state, make_train_step
from dimo_tpu_torch.utils import cameras

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "golden")
PARTS = ("frame", "vjp", "step")
PLANES = ("image", "alpha", "depth", "normal")
ALPHA_EPS = 1.0 / 255.0
SKETCH_DIM = 64
SKETCH_MIN_BYTES = 64 * 1024

# The limits (`PERF.md` §6 gives the reason of each).
PLANE_TOL = {7: 1e-4, 3: 5e-4}     # x max(1, max |ref|), test_torch_render.py
MAX_PX_FRAC = 5e-3                 # pixels allowed over the tolerance
RADII_DIFF_MAX = 10                # of the frame's radii
CPTS_ATOL = 1e-5                   # the moved control points
GRAD_REL_L2 = 1e-3                 # every gradient leaf, VJP and step
LOSS_RTOL = 1e-5                   # the step's total loss
TERM_RTOL, TERM_ATOL = 1e-4, 1e-7  # each loss term (the step tests')
LIST_TIE_DEPTH = 1e-6              # view depths of swapped list neighbours
INF = float("inf")                 # the limit of a row given for information


@dataclasses.dataclass(frozen=True)
class Spec:
    """What the vectors were made from: sizes, the frame, the step and the
    seeds. FULL is the committed files'; the tests use smaller ones."""
    n_gauss: int = 100_000
    n_cpts: int = 512
    latent_dim: int = 32
    width: int = 512
    height: int = 512
    capacity: int = 1024
    time: float = 0.35
    motion: int = 1
    shape: tuple = (4, 2, 2)        # motions, views, frames of the step
    step: int = 300
    scene_seed: int = 0
    timenet_seed: int = 1
    batch_seed: int = 0
    weight_seed: int = 2
    sketch_seed: int = 3
    lpips_seed: int = 0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["shape"] = list(self.shape)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Spec":
        return cls(**{**d, "shape": tuple(d["shape"])})


FULL = Spec()


# --- inputs from seeds -------------------------------------------------

def timenet_numpy(latent_dim: int, seed: int) -> dict:
    """TimeNet's leaves in the JAX layout ((fan_in, fan_out) weights),
    drawn by numpy at the reference's init scales (xavier-uniform weights,
    U(+-1/sqrt(fan_in)) biases); the two output heads get 0.02 N(0, 1)
    weights and 0.01 N(0, 1) biases (about the identity quaternion for
    the rotation head), so the control points move and turn."""
    rng = np.random.RandomState(seed)
    in_ch = input_dim(latent_dim)
    dims_in = [in_ch] + [WIDTH + in_ch if (i - 1) in SKIPS else WIDTH
                         for i in range(1, DEPTH)]
    layers = [(f"trunk_{i}", d, WIDTH) for i, d in enumerate(dims_in)]
    layers += [("pts_0", WIDTH, WIDTH), ("rot_0", WIDTH, WIDTH)]
    out = {}
    for name, fan_in, fan_out in layers:
        lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
        bound = float(1.0 / np.sqrt(fan_in))
        out[f"{name}_w"] = rng.uniform(-lim, lim, (fan_in, fan_out)
                                       ).astype(np.float32)
        out[f"{name}_b"] = rng.uniform(-bound, bound, (fan_out,)
                                       ).astype(np.float32)
    for name, n, base in (("pts_1", 3, np.zeros(3)),
                          ("rot_1", 4, np.array([1.0, 0.0, 0.0, 0.0]))):
        out[f"{name}_w"] = (0.02 * rng.randn(WIDTH, n)).astype(np.float32)
        out[f"{name}_b"] = (base + 0.01 * rng.randn(n)).astype(np.float32)
    return out


def scene_numpy(spec: Spec = FULL) -> dict:
    """The scene's leaves as `io/convert.py::params_from_numpy` takes them:
    `scenes.flagship_numpy`'s Gaussians and control points, c_radius -3,
    r 0, the codes and TimeNet from `spec.timenet_seed`."""
    d = flagship_numpy(spec.n_gauss, spec.n_cpts, spec.scene_seed)
    n, m = spec.n_gauss, spec.n_cpts
    net = timenet_numpy(spec.latent_dim, spec.timenet_seed)
    codes = np.random.RandomState(spec.timenet_seed + 1000).randn(
        4, spec.latent_dim).astype(np.float32)
    d.update(features_rest=np.zeros((n, 0, 3), np.float32),
             c_radius=np.full((m, 1), -3.0, np.float32),
             r=np.zeros((1, 1), np.float32), latent={"codes": codes},
             timenet=net, active=np.ones((n,), bool),
             c_active=np.ones((m,), bool))
    return d


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(d):
        v = d[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def scene_hash(leaves: dict, spec: Spec) -> str:
    """sha256 of every scene leaf (name, dtype, shape, bytes) and the spec
    with its seeds: the name the committed files give their scene."""
    h = hashlib.sha256(json.dumps(spec.to_json(), sort_keys=True).encode())
    for k, v in _flat(leaves).items():
        v = np.asarray(v, order="C")
        h.update(f"{k}|{v.dtype.str}|{v.shape}|".encode())
        h.update(v.tobytes())
    return h.hexdigest()


def batch_numpy(spec: Spec, c_xyz: np.ndarray) -> dict:
    """`scripts/bench_train.py`'s batch draws in its order from
    RandomState(batch_seed): B azimuths, times, GT images, GT masks; then
    the guidance noise."""
    n_m, n_v, n_f = spec.shape
    b = n_m * n_v * n_f
    rng = np.random.RandomState(spec.batch_seed)
    az = np.array([rng.uniform(0, 360) for _ in range(b)])
    times = rng.rand(b).astype(np.float32)
    h, w = spec.height, spec.width
    gt_image = rng.randint(0, 255, (b, h, w, 3), np.uint8)
    gt_mask = rng.randint(0, 255, (b, h, w), np.uint8)
    guidance = (c_xyz[None] + rng.randn(b, *c_xyz.shape) * 0.01
                ).astype(np.float32)
    lidx = np.repeat(np.arange(n_m), n_v * n_f).astype(np.int32)
    return {"azimuths": az, "times": times, "latent_idx": lidx,
            "mse_w": np.ones((b,), np.float32), "gt_image": gt_image,
            "gt_mask": gt_mask, "guidance": guidance}


def plane_weights(spec: Spec) -> dict:
    """W_f of the VJP's sum_f W_f * plane_f: uniform in [0.5, 1.5] from
    RandomState(weight_seed), in PLANES' order."""
    rng = np.random.RandomState(spec.weight_seed)
    hw = (spec.height, spec.width)
    shapes = {"image": (3, *hw), "alpha": (1, *hw), "depth": (1, *hw),
              "normal": (3, *hw)}
    return {f: (rng.rand(*shapes[f]) + 0.5).astype(np.float32)
            for f in PLANES}


# --- gradient sketches -------------------------------------------------

def _sketch_vectors(name: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
    return rng.standard_normal((SKETCH_DIM, n), dtype=np.float32)


def sketch(grads: dict, seed: int) -> dict:
    """{name: float32 gradient in the JAX layout} -> the stored entries:
    `grad/{name}/whole`, or `grad/{name}/{norm,max,proj}` (float64)."""
    out = {}
    for name, g in sorted(grads.items()):
        g = np.asarray(g, np.float32)
        if g.nbytes <= SKETCH_MIN_BYTES:
            out[f"grad/{name}/whole"] = g
            continue
        flat = g.reshape(-1).astype(np.float64)
        v = _sketch_vectors(name, flat.size, seed).astype(np.float64)
        out[f"grad/{name}/norm"] = np.float64(np.linalg.norm(flat))
        out[f"grad/{name}/max"] = np.float64(np.abs(flat).max(initial=0.0))
        out[f"grad/{name}/proj"] = v @ flat
    return out


def grad_rows(ref: dict, grads: dict, seed: int, what: str) -> list:
    """One row a leaf: the relative L2 of the port's gradient against the
    reference's, exact for whole leaves, through the sketch otherwise
    (sqrt of the mean squared projection difference over the reference's
    norm; about +-9% of itself with 64 projections)."""
    names = sorted({k.split("/")[1] for k in ref if k.startswith("grad/")})
    if sorted(grads) != names:
        raise ValueError(f"{what}: the port's leaves {sorted(grads)} are not "
                         f"the reference's {names}")
    rows = []
    for name in names:
        g = np.asarray(grads[name], np.float32)
        whole = ref.get(f"grad/{name}/whole")
        if whole is not None:
            if whole.shape != g.shape:
                raise ValueError(f"{what} {name}: shape {g.shape} against "
                                 f"{whole.shape}")
            ref_norm = float(np.linalg.norm(whole.astype(np.float64)))
            diff = float(np.linalg.norm(g.astype(np.float64)
                                        - whole.astype(np.float64)))
            how = "whole"
        else:
            s = sketch({name: g}, seed)
            ref_norm = float(ref[f"grad/{name}/norm"])
            d = s[f"grad/{name}/proj"] - ref[f"grad/{name}/proj"]
            diff = float(np.sqrt(np.mean(d * d)))
            how = "sketch"
        rel = diff / ref_norm if ref_norm else float(np.linalg.norm(g))
        rows.append(row(f"{what} grad {name} rel L2 ({how})", rel,
                        GRAD_REL_L2))
    return rows


# --- the comparisons -----------------------------------------------------

def row(what: str, value, limit) -> dict:
    """A difference beside its limit."""
    value = value if isinstance(value, int) else float(value)
    return {"what": what, "value": value, "limit": limit,
            "ok": bool(value <= limit)}


def plane_diff(got: np.ndarray, ref: np.ndarray, tol: float) -> dict:
    """`tests/torch_parity.py::assert_close_except_cut_flips`'s rule as
    numbers: the pixels whose error exceeds `tol` in any channel (at most
    max(2, MAX_PX_FRAC * H * W)), and the largest error against one alpha
    cut's step, 2/255 * max(1, max |ref|) of its channel + tol."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if got.shape != ref.shape:
        raise ValueError(f"shape {got.shape} against {ref.shape}")
    err = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    bad = int((err > tol).any(axis=0).sum())
    limit = max(2, int(MAX_PX_FRAC * got.shape[1] * got.shape[2]))
    scale = np.maximum(np.abs(ref).reshape(ref.shape[0], -1).max(axis=1), 1.0)
    step = 2.0 * ALPHA_EPS * scale[:, None, None] + tol
    return {"px_over_tol": bad, "px_limit": limit,
            "max_err": float(err.max(initial=0.0)),
            "max_err_over_step": float((err / step).max(initial=0.0))}


def plane_rows(got: np.ndarray, ref: np.ndarray, channels: int,
               what: str, everywhere: bool = True) -> list:
    """The plane's pixel count over the tolerance against its limit and,
    with `everywhere`, its largest error against one alpha cut's step;
    else that error is given for information."""
    tol = PLANE_TOL[channels] * max(1.0, float(np.abs(ref).max()))
    d = plane_diff(got, ref, tol)
    return [row(f"{what} px over {tol:.3g}", d["px_over_tol"], d["px_limit"]),
            row(f"{what} max |err| / (2/255 scale + tol)"
                + ("" if everywhere else " (information)"),
                d["max_err_over_step"], 1.0 if everywhere else INF),
            row(f"{what} max |err| (information)", d["max_err"], INF)]


def list_rows(ref_idx, ref_count, idx, count, depth) -> list:
    """The port's strip lists against the reference's: the same counts,
    and every entry in the reference's place except where two neighbours
    of a list trade places, whose view depths must then lie within
    LIST_TIE_DEPTH (the binning sorts by a 22-bit depth key; the
    reference's sort is not stable, and its own depths round otherwise
    under another compilation)."""
    live = np.arange(idx.shape[1])[None] < ref_count[:, None]
    d = (idx != ref_idx) & live
    pair = (d[:, :-1] & d[:, 1:] & (idx[:, :-1] == ref_idx[:, 1:])
            & (idx[:, 1:] == ref_idx[:, :-1]))
    swapped = np.zeros_like(d)
    swapped[:, :-1] |= pair
    swapped[:, 1:] |= pair
    depth = np.append(depth, np.inf)
    gap = np.abs(depth[idx[:, :-1][pair]] - depth[idx[:, 1:][pair]])
    return [row("frame strips whose list count differs",
                int((count != ref_count).sum()), 0),
            row("frame list entries off the reference's place, not a swap "
                "of neighbours", int((d & ~swapped).sum()), 0),
            row(f"frame swapped neighbours ({int(pair.sum())}) depth gap",
                gap.max(initial=0.0), LIST_TIE_DEPTH)]


def frame_rows(ref: dict, out7: dict, out3: dict, given7: dict,
               given3: dict) -> list:
    """out7 / out3: the port's frame; given7 / given3: the same frame
    composited over the reference's strip lists."""
    rows = list_rows(ref["lists/idx"], ref["lists/count"], out7["lists_idx"],
                     out7["lists_count"], out7["list_depth"])
    for f in PLANES:
        rows += plane_rows(given7[f], ref[f"ch7/{f}"], 7,
                           f"frame ch7 {f}, the reference's lists,")
    rows += plane_rows(given3["image"], ref["ch3/image"], 3,
                       "frame ch3 image, the reference's lists,")
    for f in PLANES:
        rows += plane_rows(out7[f], ref[f"ch7/{f}"], 7, f"frame ch7 {f}",
                           everywhere=False)
    rows += plane_rows(out3["image"], ref["ch3/image"], 3, "frame ch3 image",
                       everywhere=False)
    for key in ("overflow", "overflow_max"):
        for ch, out in ((7, out7), (3, out3)):
            got, want = out[key].item(), ref[f"ch{ch}/{key}"].item()
            rows.append(row(f"frame ch{ch} {key} {got} vs {want}",
                            abs(got - want), 0))
    rows.append(row("frame radii differing",
                    int((np.asarray(out7["radii"]) != ref["ch7/radii"]).sum()),
                    RADII_DIFF_MAX))
    rows.append(row("frame cpts_t max |err|",
                    np.abs(out7["cpts_t"] - ref["ch7/cpts_t"]).max(),
                    CPTS_ATOL))
    other = (np.sort(out7["knn_idx"], 0) != np.sort(ref["knn/idx"], 0)
             ).any(axis=0)
    ties = ref["knn/near_ties"]
    rows.append(row("frame KNN Gaussians with another neighbour set "
                    "(information)", int(other.sum()), INF))
    rows.append(row(f"frame KNN near-tie Gaussians ({ties.size}) with "
                    "another neighbour set (information)",
                    int(other[ties].sum()), INF))
    return rows


def step_rows(ref: dict, loss: float, metrics: dict, grads: dict,
              seed: int) -> list:
    rows = [row("step loss rel", abs(loss - float(ref["loss"]))
                / abs(float(ref["loss"])), LOSS_RTOL)]
    names = sorted(k[len("metric/"):] for k in ref if k.startswith("metric/"))
    if sorted(metrics) != names:
        raise ValueError(f"step metrics {sorted(metrics)} against {names}")
    for k in names:
        want, got = float(ref[f"metric/{k}"]), float(metrics[k])
        err = abs(got - want)
        lim = TERM_ATOL + TERM_RTOL * abs(want)
        rows.append(row(f"step {k} |err| ({got:.7g} vs {want:.7g})", err, lim))
    return rows + grad_rows(ref, grads, seed, "step")


# --- the port's side -------------------------------------------------------

def port_scene(spec: Spec, device):
    """(cfg, params, aux, camera) of the spec's scene on `device`."""
    params, aux = params_from_numpy(scene_numpy(spec), device=device)
    cfg = G.ModelConfig(sh_degree=0, latent_dim=spec.latent_dim,
                        num_latents=4, capacity=spec.n_gauss,
                        cpt_capacity=spec.n_cpts)
    return cfg, params, aux, flagship_camera()


def port_grads(params) -> dict:
    """{JAX leaf name: numpy gradient in the JAX layout} of every leaf."""
    def g(t, transpose=False):
        a = (t.grad if t.grad is not None else torch.zeros_like(t))
        a = a.detach().cpu().numpy()
        return a.T.copy() if transpose else a

    out = {f: g(getattr(params, f)) for f in G.PARAM_FIELDS}
    out.update({f"latent.{k}": g(v) for k, v in params.latent.items()})
    for name, lin in _timenet_layers(params.timenet).items():
        out[f"timenet.{name}_w"] = g(lin.weight, transpose=True)
        out[f"timenet.{name}_b"] = g(lin.bias)
    return out


def _numpy(out: dict) -> dict:
    return {k: (v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in out.items()}


@contextlib.contextmanager
def strip_lists(seen: list, given: tuple | None = None):
    """Inside: each `strips.build_strip_lists` call appends its lists and
    the depths it sorted to `seen`; with `given` = (idx, count), the
    compositor gets those lists in place of its own."""
    orig = strips.build_strip_lists

    def spy(mean2d, radius, depth, ok, height, width, capacity):
        # `render` bins its one job along a leading render axis of one
        own = orig(mean2d, radius, depth, ok, height, width, capacity)
        seen.append((strips.StripLists(*(x[0] for x in own)), depth[0]))
        if given is None:
            return own
        dev = own.idx.device
        return own._replace(idx=torch.from_numpy(given[0]).to(dev)[None],
                            count=torch.from_numpy(given[1]).to(dev)[None])

    strips.build_strip_lists = spy
    try:
        yield
    finally:
        strips.build_strip_lists = orig


def port_frame(spec: Spec, device, channels: int, scene=None,
               lists: tuple | None = None) -> dict:
    """The spec's frame through `models/renderer.py::render`, as numpy,
    with the KNN it used (`knn_idx`) and its own strip lists and depths
    (`lists_idx`, `lists_count`, `list_depth`); with `lists` = (idx, count),
    composited over those lists instead."""
    cfg, params, aux, cam = scene or port_scene(spec, device)
    seen = []
    with torch.no_grad(), strip_lists(seen, lists):
        knn = find_knn(params, aux)
        out = render(cfg, params, aux, cam, spec.time, "s2", spec.motion,
                     spec.width, spec.height,
                     torch.ones(3, device=params.xyz.device), knn_cache=knn,
                     capacity=spec.capacity, channels=channels)
    [(own, depth)] = seen
    return _numpy(dict(out, knn_idx=knn[1], lists_idx=own.idx,
                       lists_count=own.count, list_depth=depth))


def port_vjp(spec: Spec, device) -> dict:
    """The gradient of sum_f W_f * plane_f of the ch7 frame to every leaf."""
    cfg, params, aux, cam = port_scene(spec, device)
    init_state(params, aux)                     # every leaf trainable
    dev = params.xyz.device
    out = render(cfg, params, aux, cam, spec.time, "s2", spec.motion,
                 spec.width, spec.height, torch.ones(3, device=dev),
                 capacity=spec.capacity, channels=7)
    w = plane_weights(spec)
    total = sum(torch.sum(out[f] * torch.from_numpy(w[f]).to(dev))
                for f in PLANES)
    total.backward()
    return port_grads(params)


def port_batch(spec: Spec, c_xyz: np.ndarray, device) -> dict:
    bn = batch_numpy(spec, c_xyz)
    fov = float(np.deg2rad(33.9))
    dev = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return {"camera": [cameras.Camera.from_c2w(
                cameras.orbit_camera(0, float(a), 2.0), fov, fov)
                for a in bn["azimuths"]],
            "times": bn["times"], "latent_idx": bn["latent_idx"],
            "mse_w": dev(bn["mse_w"]), "gt_image": dev(bn["gt_image"]),
            "gt_mask": dev(bn["gt_mask"]), "guidance": dev(bn["guidance"])}


def port_step(spec: Spec, device, arap_times: np.ndarray) -> tuple:
    """(loss, metrics, grads) of the spec's s2 step with LPIPS on, before
    Adam, ARAP at `arap_times`."""
    cfg, params, aux, _ = port_scene(spec, device)
    dev = params.xyz.device
    state = init_state(params, aux, step=spec.step - 1)
    fn = make_train_step(cfg, LossConfig(), "s2", spec.width, spec.height,
                         *spec.shape, capacity=spec.capacity,
                         lpips_fn=random_init_lpips(spec.lpips_seed, dev),
                         use_guidance=True)
    batch = port_batch(spec, scene_numpy(spec)["c_xyz"], dev)
    loss, (metrics, _) = fn.loss_fn(state.params, state.aux, batch,
                                    spec.step, arap_times=arap_times)
    loss.backward()
    metrics = {k: float(v) for k, v in metrics.items()}
    return float(loss.detach()), metrics, port_grads(state.params)


# --- the files --------------------------------------------------------------

def path_of(part: str, folder: str = GOLDEN) -> str:
    return os.path.join(folder, f"torch_reference_{part}.npz")


def write_vectors(path: str, meta: dict, arrays: dict) -> None:
    """An .npz that np.load reads, written byte for byte the same from the
    same arrays: fixed entry dates, sorted names. Float32 arrays of 2 or
    more dimensions are stored byte-shuffled (all first bytes, then all
    second bytes, ...), which deflate packs tighter; meta["shuffled"]
    names them with their shape."""
    meta = dict(meta, shuffled={})
    entries = {}
    for name, a in sorted(arrays.items()):
        a = np.asarray(a, order="C")
        if a.dtype == np.float32 and a.ndim >= 2:
            meta["shuffled"][name] = list(a.shape)
            a = np.ascontiguousarray(a.reshape(-1).view(np.uint8)
                                     .reshape(-1, 4).T)
        entries[name] = a
    entries["meta"] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), np.uint8)
    with zipfile.ZipFile(path, "w") as zf:
        for name in sorted(entries):
            buf = io.BytesIO()
            np.lib.format.write_array(buf, entries[name], allow_pickle=False)
            info = zipfile.ZipInfo(f"{name}.npy",
                                   date_time=(1980, 1, 1, 0, 0, 0))
            info.compress_type = zipfile.ZIP_DEFLATED
            info.external_attr = 0o644 << 16
            zf.writestr(info, buf.getvalue(), compresslevel=9)


def read_vectors(path: str) -> tuple:
    """(meta, {name: array}) of a file `write_vectors` wrote."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        arrays = {k: z[k] for k in z.files if k != "meta"}
    for name, shape in meta["shuffled"].items():
        a = arrays[name]
        arrays[name] = (np.ascontiguousarray(a.T).view(np.float32)
                        .reshape(shape))
    return meta, arrays


# --- the check --------------------------------------------------------------

def check(device, parts=PARTS, folder: str = GOLDEN, log=print,
          keep: dict | None = None) -> list:
    """Run the port on `device` against the files in `folder` and return
    every row (what, value, limit, ok); `log` gets each part's rows. With
    `keep`, the port's outputs land there as numpy (`frame7`, `frame3`,
    and the `vjp` and `step` gradients), to compare stage by stage."""
    keep = {} if keep is None else keep
    rows = []
    for part in parts:
        meta, ref = read_vectors(path_of(part, folder))
        spec = Spec.from_json(meta["spec"])
        same = scene_hash(scene_numpy(spec), spec) == meta["scene_hash"]
        new = [row(f"{part} scene hash differs", int(not same), 0)]
        if part == "frame":
            scene = port_scene(spec, device)
            given = (ref["lists/idx"], ref["lists/count"])
            for ch in (7, 3):
                keep[f"frame{ch}"] = port_frame(spec, device, ch, scene)
                keep[f"given{ch}"] = port_frame(spec, device, ch, scene,
                                                given)
            new += frame_rows(ref, *(keep[k] for k in
                                     ("frame7", "frame3", "given7",
                                      "given3")))
        elif part == "vjp":
            keep["vjp"] = port_vjp(spec, device)
            new += grad_rows(ref, keep["vjp"], spec.sketch_seed, "vjp")
        else:
            loss, metrics, keep["step"] = port_step(spec, device,
                                                    ref["arap_times"])
            new += step_rows(ref, loss, metrics, keep["step"],
                             spec.sketch_seed)
        for r in new:
            log(f"reference {r['what']}: {r['value']} (limit {r['limit']}) "
                f"{'ok' if r['ok'] else 'OVER'}")
        rows += new
    return rows
