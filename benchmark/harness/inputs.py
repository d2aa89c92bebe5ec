"""Everything a run feeds the program, made from `--seed`: the scene
(Gaussians, control points, latent codes, TimeNet), the LPIPS-VGG
weights, the dataset of frames and masks, the stage-1 guidance
trajectories and the request streams. The same seed gives the same
inputs. Both the program and the reference get these same arrays.

Large draws are made on the device by a `torch.Generator` in a few calls;
the Gaussians follow the flagship scene's draw rules (numpy, a thick
shell), copied here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import lpips as ref_lpips
from reference import timenet as ref_timenet


def sub_seed(seed: int, tag: str) -> int:
    """A 31-bit seed for one input, from the run's seed and the input's
    name (any whole number of up to 64 bits is a run's seed)."""
    words = [seed % (1 << 64), int.from_bytes(tag.encode(), "little")]
    return int(np.random.SeedSequence(words).generate_state(1)[0]) & 0x7FFFFFFF


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def flagship_numpy(n_gauss: int, n_cpts: int, seed: int) -> dict:
    """The flagship scene's Gaussians: a thick shell of radius 0.45 +- 0.04
    with 15% interior filler, log-normal scales of a few pixels at 512^2,
    mostly opaque, and `n_cpts` of the points as control points."""
    rng = np.random.RandomState(seed)
    d = rng.randn(n_gauss, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-9
    r = 0.45 + rng.randn(n_gauss, 1) * 0.04
    xyz = (d * r).astype(np.float32)
    n_fill = n_gauss * 15 // 100
    xyz[:n_fill] = rng.uniform(-0.4, 0.4, (n_fill, 3)).astype(np.float32)
    log_s = (rng.randn(n_gauss, 3) * 0.4 - 5.3).astype(np.float32)
    opac_raw = (rng.randn(n_gauss, 1) * 1.5 + 1.5).astype(np.float32)
    features_dc = (rng.randn(n_gauss, 1, 3) * 0.3).astype(np.float32)
    rotation = rng.randn(n_gauss, 4).astype(np.float32)
    c_xyz = xyz[rng.choice(n_gauss, n_cpts, replace=False)]
    return {"xyz": xyz, "features_dc": features_dc, "scaling": log_s,
            "opacity": opac_raw, "rotation": rotation, "c_xyz": c_xyz}


def timenet_numpy(latent_dim: int, gen: torch.Generator) -> dict:
    """TimeNet's leaves in (fan_in, fan_out) layout: xavier-uniform weights
    and U(+-1/sqrt(fan_in)) biases in the trunk and the first layer of
    each head; N(0, 0.02) weights in the two output layers, whose biases
    are 0 (translation) and [1, 0, 0, 0] (rotation), so the control
    points move with t."""
    w_ = ref_timenet.WIDTH
    fin = ref_timenet.input_dim(latent_dim)
    dims = [fin] + [w_ + fin if (i - 1) in ref_timenet.SKIPS else w_
                    for i in range(1, ref_timenet.DEPTH)]
    shapes = {f"trunk_{i}": (d, w_) for i, d in enumerate(dims)}
    shapes.update(pts_0=(w_, w_), rot_0=(w_, w_))
    n = sum(a * b + b for a, b in shapes.values())
    u = torch.rand(n, generator=gen, device=gen.device) * 2.0 - 1.0
    out, at = {}, 0
    for name, (a, b) in shapes.items():
        limit, bound = math.sqrt(6.0 / (a + b)), 1.0 / math.sqrt(a)
        out[f"{name}_w"] = u[at:at + a * b].reshape(a, b) * limit
        out[f"{name}_b"] = u[at + a * b:at + a * b + b] * bound
        at += a * b + b
    z = torch.randn(w_ * 7, generator=gen, device=gen.device) * 0.02
    out["pts_1_w"] = z[:w_ * 3].reshape(w_, 3)
    out["rot_1_w"] = z[w_ * 3:].reshape(w_, 4)
    out["pts_1_b"] = torch.zeros(3, device=gen.device)
    out["rot_1_b"] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=gen.device)
    return {k: v.cpu().numpy() for k, v in out.items()}


def scene(cfg: dict, seed: int, device) -> dict:
    """The model's state in the JAX package's numpy layout (the parameter
    fields, "latent", "timenet", "active", "c_active"), which both the
    program's `io/convert.params_from_numpy` and the reference read."""
    s = cfg["scene"]
    n, n_c = int(s["num_gaussians"]), int(cfg["num_cpts"])
    d = flagship_numpy(n, n_c, sub_seed(seed, "scene"))
    d["scaling"] = d["scaling"] + np.float32(s.get("log_scale_shift", 0.0))
    gen = generator(seed, "latent", device)
    codes = torch.randn((int(s["num_motions"]), int(cfg["latent_code_dim"])),
                        generator=gen, device=gen.device)
    d.update(
        features_rest=np.zeros((n, 0, 3), np.float32),
        c_radius=np.full((n_c, 1), -3.0, np.float32),
        r=np.full((1, 1), float(np.median(d["scaling"])), np.float32),
        latent={"codes": codes.cpu().numpy()},
        timenet=timenet_numpy(int(cfg["latent_code_dim"]),
                              generator(seed, "timenet", device)),
        active=np.ones((n,), bool), c_active=np.ones((n_c,), bool))
    return d


def lpips_numpy(seed: int, device) -> dict:
    """LPIPS-VGG weights under the reference's keys: He-initialised 3x3
    filters, zero biases, uniform heads of 1/C (the repo has no trained
    weights; the program's fallback draws the same kind)."""
    gen = generator(seed, "lpips", device)
    shapes, c_in = [], 3
    for c_out, _ in ref_lpips._VGG_PLAN:
        shapes.append((c_out, c_in, 3, 3))
        c_in = c_out
    z = torch.randn(sum(math.prod(s) for s in shapes), generator=gen,
                    device=gen.device)
    out, at = {}, 0
    for i, s in enumerate(shapes):
        k = math.prod(s)
        w = z[at:at + k].reshape(s) * math.sqrt(2.0 / (s[1] * 9))
        out[f"conv{i}_w"] = w.cpu().numpy()
        out[f"conv{i}_b"] = np.zeros((s[0],), np.float32)
        at += k
    for k, c in enumerate(ref_lpips.TAP_CHANNELS):
        out[f"lin{k}_w"] = np.full((c,), 1.0 / c, np.float32)
    return out


def dataset(cfg: dict, seed: int, device) -> tuple:
    """uint8 frames (M, V, F, S, S, 3) and masks (M, V, F, S, S) in host
    memory, drawn on the device a motion at a time and copied down."""
    s = cfg["scene"]
    m, v, f = int(s["num_motions"]), int(cfg["num_views"]), \
        int(cfg["num_frames"])
    size = int(cfg["ref_size"])
    images = np.empty((m, v, f, size, size, 3), np.uint8)
    masks = np.empty((m, v, f, size, size), np.uint8)
    gen = generator(seed, "dataset", device)
    ti, tm = torch.from_numpy(images), torch.from_numpy(masks)
    for i in range(m):
        ti[i].copy_(torch.randint(0, 256, ti[i].shape, dtype=torch.uint8,
                                  generator=gen, device=gen.device))
        tm[i].copy_(torch.randint(0, 256, tm[i].shape, dtype=torch.uint8,
                                  generator=gen, device=gen.device))
    return images, masks


def guidance(cfg: dict, c_xyz: np.ndarray, seed: int, device) -> np.ndarray:
    """Stage-1 trajectories of the control points, (M, F, Mc, 3): the
    canonical points moved by N(0, 0.02) per motion and frame."""
    s = cfg["scene"]
    gen = generator(seed, "guidance", device)
    shape = (int(s["num_motions"]), int(cfg["num_frames"])) + c_xyz.shape
    z = torch.randn(shape, generator=gen, device=gen.device) * 0.02
    return (torch.as_tensor(c_xyz, device=gen.device) + z).cpu().numpy()


def requests(n: int, num_motions: int, seed: int) -> list:
    """A stream of `n` serving requests [(motion, camera)], cameras
    alternating "fixed" and "circle"; only the motions depend on the
    seed, so every seed asks for the same work."""
    rng = np.random.RandomState(sub_seed(seed, "requests"))
    motions = rng.randint(0, num_motions, n)
    return [(int(mo), "fixed" if i % 2 == 0 else "circle")
            for i, mo in enumerate(motions)]
