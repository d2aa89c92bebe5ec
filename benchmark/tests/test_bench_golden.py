"""The yardstick held to an independent package: the benchmark's plain
reference renders the flagship frame that the JAX package rendered on
the CPU (`tests/golden/torch_reference_frame.npz`: 100,000 Gaussians,
512 control points, latent 32, t = 0.35, motion 1, 512^2, capacity
1,024), from the same numpy seeds rebuilt with the benchmark's own copy
of the draw rules. Over the JAX package's own strip lists each ch7 plane
passes the rule the port was held to at full width: at most 0.5% of the
pixels off by more than 1e-4 x max(1, max |ref|), and no error above one
alpha cut's step (2/255 of the scale, plus that tolerance).

The reference's backward, which `grad_gap` and `change_gap` read, is held
the same way to the JAX package's VJP of that frame
(`tests/golden/torch_reference_vjp.npz`: the gradient of
sum_f W_f * plane_f to every leaf): every leaf within 1e-3 relative L2,
exact for small leaves and through the file's 64 random projections for
large ones, the rule the port was held to. The loss terms of the JAX
package's LPIPS-on s2 step (`tests/golden/torch_reference_step.npz`: 4
motions x 2 views x 2 frames at 512^2, step 300) are held to 1e-4
relative plus 1e-7, the step's rule, all but ARAP, whose neighbours the
two sides draw from different generators. So the reference computes
DIMO both ways, and not a copy of the port's mistakes."""
from __future__ import annotations

import functools
import json
import os
import zlib

import numpy as np
import pytest
import torch

from conftest import ROOT
from harness.inputs import flagship_numpy
from reference import batches, model
from reference import lpips as ref_lpips
from reference import step as ref_step
from reference.render import find_knn, render

GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_reference_frame.npz")
GOLDEN_VJP = os.path.join(ROOT, "tests", "golden", "torch_reference_vjp.npz")
GOLDEN_STEP = os.path.join(ROOT, "tests", "golden",
                           "torch_reference_step.npz")
PLANES = ("image", "alpha", "depth", "normal")
WIDTH, DEPTH, SKIPS = 256, 8, (4,)
SKETCH_DIM = 64
GRAD_REL_L2 = 1e-3
TERM_RTOL, TERM_ATOL = 1e-4, 1e-7


def read_golden(path: str) -> tuple:
    """(spec, {name: array}); float planes are stored as their bytes
    shuffled into (4, n) uint8."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        arrays = {k: z[k] for k in z.files if k != "meta"}
    for name, shape in meta["shuffled"].items():
        arrays[name] = (np.ascontiguousarray(arrays[name].T)
                        .view(np.float32).reshape(shape))
    return meta["spec"], arrays


def timenet_numpy(latent_dim: int, seed: int) -> dict:
    """The golden scene's TimeNet, drawn by numpy: xavier-uniform weights
    and U(+-1/sqrt(fan_in)) biases, output heads 0.02 N(0, 1) with biases
    0.01 N(0, 1) about 0 and [1, 0, 0, 0]."""
    rng = np.random.RandomState(seed)
    fin = 3 * 2 * 10 + 2 * 6 + latent_dim
    dims = [fin] + [WIDTH + fin if (i - 1) in SKIPS else WIDTH
                    for i in range(1, DEPTH)]
    layers = [(f"trunk_{i}", d, WIDTH) for i, d in enumerate(dims)]
    layers += [("pts_0", WIDTH, WIDTH), ("rot_0", WIDTH, WIDTH)]
    out = {}
    for name, a, b in layers:
        lim, bound = float(np.sqrt(6.0 / (a + b))), float(1.0 / np.sqrt(a))
        out[f"{name}_w"] = rng.uniform(-lim, lim, (a, b)).astype(np.float32)
        out[f"{name}_b"] = rng.uniform(-bound, bound, (b,)).astype(np.float32)
    for name, n, base in (("pts_1", 3, np.zeros(3)),
                          ("rot_1", 4, np.array([1.0, 0.0, 0.0, 0.0]))):
        out[f"{name}_w"] = (0.02 * rng.randn(WIDTH, n)).astype(np.float32)
        out[f"{name}_b"] = (base + 0.01 * rng.randn(n)).astype(np.float32)
    return out


def golden_scene(spec: dict) -> dict:
    n, m, lat = spec["n_gauss"], spec["n_cpts"], spec["latent_dim"]
    d = flagship_numpy(n, m, spec["scene_seed"])
    codes = np.random.RandomState(spec["timenet_seed"] + 1000).randn(
        4, lat).astype(np.float32)
    d.update(features_rest=np.zeros((n, 0, 3), np.float32),
             c_radius=np.full((m, 1), -3.0, np.float32),
             r=np.zeros((1, 1), np.float32), latent={"codes": codes},
             timenet=timenet_numpy(lat, spec["timenet_seed"]))
    return d


def plane_check(got: np.ndarray, ref: np.ndarray) -> tuple:
    """(pixels over the tolerance, their limit, largest error over one
    alpha cut's step)."""
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    err = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    bad = int((err > tol).any(axis=0).sum())
    limit = max(2, int(5e-3 * got.shape[1] * got.shape[2]))
    scale = np.maximum(np.abs(ref).reshape(ref.shape[0], -1).max(1), 1.0)
    step = 2.0 / 255.0 * scale[:, None, None] + tol
    return bad, limit, float((err / step).max())


CAMERA = {"fovy": 33.9, "W": 1, "H": 1, "elevation": 0, "radius": 2.0}


def golden_render(spec: dict, params, ref: dict) -> dict:
    """The golden frame (ch7) through the reference, over the JAX
    package's own strip lists."""
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    return render(params, batches.camera(30.0, CAMERA), spec["time"], "s2",
                  spec["motion"], spec["width"], spec["height"],
                  torch.ones(3), spec["capacity"], knn=find_knn(params),
                  given=(ref["lists/idx"], ref["lists/count"]))


def plane_weights(spec: dict) -> dict:
    """W_f of the VJP: uniform in [0.5, 1.5] from RandomState(weight_seed),
    drawn in PLANES' order."""
    rng = np.random.RandomState(spec["weight_seed"])
    hw = (spec["height"], spec["width"])
    shapes = {"image": (3, *hw), "alpha": (1, *hw), "depth": (1, *hw),
              "normal": (3, *hw)}
    return {f: (rng.rand(*shapes[f]) + 0.5).astype(np.float32)
            for f in PLANES}


def jax_layout_grads(params) -> dict:
    """{JAX leaf name: gradient}, TimeNet's weights as (fan_in, fan_out)."""
    g = lambda t: (t.grad if t.grad is not None  # noqa: E731
                   else torch.zeros_like(t)).detach().numpy()
    out = {f: g(getattr(params, f)) for f in model.PARAM_FIELDS}
    out.update({f"latent.{k}": g(v) for k, v in params.latent.items()})
    for name, p in params.timenet.named_parameters():
        layer, _, kind = name.rpartition(".")
        layer = layer.replace("trunk.", "trunk_")
        out[f"timenet.{layer}_{kind[0]}"] = g(p).T if kind == "weight" \
            else g(p)
    return out


def sketch_rel_l2(got: np.ndarray, ref: dict, name: str, seed: int) -> float:
    """|got - ref| / |ref| through the file's projections: the root mean
    squared difference of 64 projections on N(0, 1) vectors drawn from
    default_rng([seed, crc32(name)]), over the reference's norm."""
    flat = got.reshape(-1).astype(np.float64)
    rng = np.random.default_rng([seed, zlib.crc32(name.encode())])
    v = rng.standard_normal((SKETCH_DIM, flat.size), dtype=np.float32)
    d = v.astype(np.float64) @ flat - ref[f"grad/{name}/proj"]
    return float(np.sqrt(np.mean(d * d))) / float(ref[f"grad/{name}/norm"])


@functools.lru_cache(maxsize=None)
def reference_vjp() -> tuple:
    """(the JAX package's VJP file, the reference's gradients)."""
    frame_spec, frame = read_golden(GOLDEN)
    spec, ref = read_golden(GOLDEN_VJP)
    assert spec == frame_spec
    params = model.from_numpy(golden_scene(spec), "cpu")
    out = golden_render(spec, params, frame)
    w = plane_weights(spec)
    sum(torch.sum(out[f] * torch.from_numpy(w[f])) for f in PLANES).backward()
    return (spec, ref), jax_layout_grads(params)


def _vjp_leaves() -> list:
    with np.load(GOLDEN_VJP, allow_pickle=False) as z:
        return sorted({k.split("/")[1] for k in z.files if k != "meta"})


@pytest.mark.parametrize("leaf", _vjp_leaves())
def test_reference_backward_matches_the_jax_packages_vjp(leaf):
    (spec, ref), grads = reference_vjp()
    assert sorted(grads) == _vjp_leaves()
    got = grads[leaf].astype(np.float64)
    whole = ref.get(f"grad/{leaf}/whole")
    if whole is not None:
        assert got.shape == whole.shape
        ref_norm = float(np.linalg.norm(whole.astype(np.float64)))
        diff = float(np.linalg.norm(got - whole.astype(np.float64)))
        rel = diff / ref_norm if ref_norm else float(np.linalg.norm(got))
    else:
        rel = sketch_rel_l2(grads[leaf], ref, leaf, spec["sketch_seed"])
        norm = float(ref[f"grad/{leaf}/norm"])
        assert abs(np.linalg.norm(got) - norm) <= GRAD_REL_L2 * norm
    assert rel <= GRAD_REL_L2, (leaf, rel)


def test_reference_renders_the_jax_packages_frame():
    spec, ref = read_golden(GOLDEN)
    params = model.from_numpy(golden_scene(spec), "cpu")
    with torch.no_grad():
        out = golden_render(spec, params, ref)
    for f in PLANES:
        bad, limit, over_step = plane_check(out[f].numpy(), ref[f"ch7/{f}"])
        assert bad <= limit, (f, bad, limit)
        assert over_step <= 1.0, (f, over_step)
    assert np.abs(out["cpts_t"].numpy() - ref["ch7/cpts_t"]).max() <= 1e-5
    assert int(out["overflow"]) == int(ref["ch7/overflow"])


def step_batch(spec: dict, c_xyz: np.ndarray) -> dict:
    """The golden step's batch, drawn in its order from
    RandomState(batch_seed): B azimuths, times, GT images, GT masks, then
    the guidance noise; motion-major."""
    n_m, n_v, n_f = spec["shape"]
    b = n_m * n_v * n_f
    rng = np.random.RandomState(spec["batch_seed"])
    az = [rng.uniform(0, 360) for _ in range(b)]
    times = rng.rand(b).astype(np.float32)
    h, w = spec["height"], spec["width"]
    gt_image = rng.randint(0, 255, (b, h, w, 3), np.uint8)
    gt_mask = rng.randint(0, 255, (b, h, w), np.uint8)
    guidance = (c_xyz[None] + rng.randn(b, *c_xyz.shape) * 0.01
                ).astype(np.float32)
    return {"camera": [batches.camera(a, CAMERA) for a in az],
            "times": times.tolist(),
            "latent_idx": np.repeat(np.arange(n_m), n_v * n_f).tolist(),
            "mse_w": [1.0] * b, "gt_image": gt_image, "gt_mask": gt_mask,
            "guidance": guidance}


def seeded_lpips(seed: int) -> dict:
    """The JAX package's random-VGG LPIPS: He-initialised filters from
    RandomState(seed) in the plan's order, zero biases, heads of 1/C."""
    rng, out, c_in = np.random.RandomState(seed), {}, 3
    for i, (c_out, _) in enumerate(ref_lpips._VGG_PLAN):
        w = (rng.randn(c_out, c_in, 3, 3).astype(np.float32)
             * np.sqrt(2.0 / (c_in * 9)))
        out[f"conv{i}_w"] = torch.from_numpy(w.astype(np.float32))
        out[f"conv{i}_b"] = torch.zeros((c_out,))
        c_in = c_out
    for k, c in enumerate(ref_lpips.TAP_CHANNELS):
        out[f"lin{k}_w"] = torch.full((c,), 1.0 / c)
    return out


# the JAX package's LossConfig() defaults, which its step was made with
STEP_LOSS = {"lambda_mse": 5000.0, "lambda_lpips": 1000.0,
             "lambda_ssim": 500.0, "lambda_mask": 500.0,
             "lambda_smooth": 100.0, "lambda_bilateral": 0.05,
             "lambda_arap": 10.0, "lambda_ga1": 10.0,
             "depth_reg_start_iter": 200, "normal_reg_start_iter": 200,
             "arap_start_iter_s1": 1000, "arap_end_iter_s2": 2000}


def test_reference_step_terms_match_the_jax_packages_step():
    spec, ref = read_golden(GOLDEN_STEP)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    scene = golden_scene(spec)
    params = model.from_numpy(scene, "cpu")
    kw = {f.name: 0.0 for f in ref_step.dataclasses.fields(
        ref_step.LossConfig) if f.name not in ("arap_t_samples",
                                              "arap_radius")}
    kw.update(STEP_LOSS)
    n_m, n_v, n_f = spec["shape"]
    with torch.no_grad():
        _, terms, _ = ref_step.loss_fn(
            params, step_batch(spec, scene["c_xyz"]), spec["step"],
            ref_step.LossConfig(**kw), "s2", spec["width"], spec["capacity"],
            ref_lpips.LPIPS(seeded_lpips(spec["lpips_seed"])), n_v * n_f,
            torch.Generator().manual_seed(0))
    for k in ("mse", "ssim_loss", "lpips", "mask_loss", "smooth",
              "bilateral", "ga"):
        want, got = float(ref[f"metric/{k}"]), float(terms[k])
        assert abs(got - want) <= TERM_ATOL + TERM_RTOL * abs(want), (
            k, got, want)
