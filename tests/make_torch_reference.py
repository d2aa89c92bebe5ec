"""Write the reference vectors that hold the PyTorch port against the JAX
package at full width: `tests/golden/torch_reference_{frame,vjp,step}.npz`.

    JAX_PLATFORMS=cpu python tests/make_torch_reference.py [--parts frame,vjp,step]

Runs `dimo_tpu` on the CPU (its Pallas kernels in interpret mode, its LBS
gather in the exact one-hot form `_gather_cols_xla`, as
`tests/test_torch_render.py` runs it) on the inputs that
`dimo_tpu_torch/reference_check.py` rebuilds from numpy seeds, and writes
through that module's `write_vectors`:

* frame: the flagship s2 frame (100,000 Gaussians, 512 control points,
  latent 32, t = 0.35, motion 1, 512^2, capacity 1024): ch7's image,
  alpha, depth and normal, radii, overflow, overflow_max and moved
  control points, ch3's image and overflow; the strip lists the frame
  was composited over (captured inside the compiled render); the KNN
  indices and the
  Gaussians whose 4th and 5th nearest control points lie within 1e-4
  relative in squared distance (float64), whose skinning float32 rounding
  can change;
* vjp: the gradient of sum_f W_f * plane_f of the ch7 frame to every leaf;
* step: one s2 step with LPIPS on (`random_init_lpips(0)`, lambda 1000)
  at `scripts/bench_train.py`'s shape, 4 x 2 x 2 renders at 512^2,
  capacity 1024, step 300: the loss, every metric, every leaf's gradient,
  and ARAP's 8 times drawn from PRNGKey(ARAP_KEY) as the step draws them.

Gradients over 64 KB are stored as sketches (`reference_check.sketch`).
The port is checked against the files by `tests/test_torch_reference_width.py`
on the CPU and by `python3 chip_smoke.py --phase reference` on the card.
About 15 minutes on 8 CPU cores; a second run writes the same bytes.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from __graft_entry__ import _flagship_scene  # noqa: E402
from dimo_tpu.models import deform as jdef  # noqa: E402
from dimo_tpu.models import lpips as jlpips  # noqa: E402
from dimo_tpu.models import renderer as jren  # noqa: E402
from dimo_tpu.ops import smallgather as jsg  # noqa: E402
from dimo_tpu.ops.rasterizer import strips as jstrips  # noqa: E402
from dimo_tpu.train import step as jstep  # noqa: E402
from dimo_tpu.utils import cameras as jcam  # noqa: E402

from dimo_tpu_torch import reference_check as rc  # noqa: E402

ARAP_KEY = 7            # the step's RNG key, as tests/test_torch_train_step.py
NEAR_TIE_REL = 1e-4     # 4th vs 5th nearest control point, squared distance


def exact_gather(table_t, idx):
    """The JAX package's plain one-hot `gather_small_cols`, exact in
    float32 (its Pallas kernel returns bf16 hi + lo)."""
    out = jsg._gather_cols_xla(table_t.astype(jnp.float32), idx.reshape(-1))
    return out.reshape(table_t.shape[0], *idx.shape)


def jax_scene(spec: rc.Spec) -> tuple:
    """(cfg, params, aux, camera, leaves): `_flagship_scene` with the
    codes and TimeNet replaced by `reference_check.scene_numpy`'s draws,
    whose other leaves must be the scene's own."""
    cfg, jp, ja, cam = _flagship_scene(spec.n_gauss, spec.n_cpts,
                                       spec.latent_dim, spec.scene_seed)
    leaves = rc.scene_numpy(spec)
    for f in ("xyz", "features_dc", "features_rest", "scaling", "rotation",
              "opacity", "c_xyz", "c_radius", "r"):
        np.testing.assert_array_equal(np.asarray(getattr(jp, f)), leaves[f],
                                      err_msg=f)
    for k, v in jp.timenet.items():
        assert v.shape == leaves["timenet"][k].shape, k
    assert sorted(jp.timenet) == sorted(leaves["timenet"])
    assert jp.latent["codes"].shape == leaves["latent"]["codes"].shape
    jp = jp.replace(
        latent={"codes": jnp.asarray(leaves["latent"]["codes"])},
        timenet={k: jnp.asarray(v) for k, v in leaves["timenet"].items()})
    return cfg, jp, ja, cam, leaves


def grads_numpy(g) -> dict:
    """{JAX leaf name: numpy} of a gradient pytree (GaussianParams)."""
    out = {f: np.asarray(getattr(g, f)) for f in
           ("xyz", "features_dc", "features_rest", "scaling", "rotation",
            "opacity", "c_xyz", "c_radius", "r")}
    out.update({f"latent.{k}": np.asarray(v) for k, v in g.latent.items()})
    out.update({f"timenet.{k}": np.asarray(v) for k, v in g.timenet.items()})
    return out


def near_ties(xyz: np.ndarray, c_xyz: np.ndarray, k: int = 4) -> np.ndarray:
    """Gaussians whose k-th and (k+1)-th nearest control points lie within
    NEAR_TIE_REL relative in squared distance (float64)."""
    c = c_xyz.astype(np.float64)
    out = []
    for lo in range(0, xyz.shape[0], 8192):
        x = xyz[lo:lo + 8192].astype(np.float64)
        d2 = ((x[:, None, :] - c[None]) ** 2).sum(-1)
        part = np.partition(d2, (k - 1, k), axis=1)
        a, b = part[:, k - 1], part[:, k]
        out.append(lo + np.nonzero(b - a <= NEAR_TIE_REL * a)[0])
    return np.concatenate(out).astype(np.int32)


def captured_lists(fn):
    """fn() with the strip lists that `dimo_tpu`'s binning makes inside it
    captured as it makes them (a host callback in the compiled program):
    (fn's result, [(idx, count), ...])."""
    seen = []
    orig = jstrips.build_strip_lists

    def spy(*args):
        lists = orig(*args)
        jax.debug.callback(lambda i, c: seen.append((np.asarray(i),
                                                     np.asarray(c))),
                           lists.idx, lists.count)
        return lists

    jstrips.build_strip_lists = spy
    try:
        return jax.block_until_ready(fn()), seen
    finally:
        jstrips.build_strip_lists = orig


def jax_frame(spec: rc.Spec, scene) -> dict:
    cfg, jp, ja, cam, leaves = scene
    bg = jnp.ones((3,))
    out = {}
    for ch in (7, 3):
        o, [lists] = captured_lists(lambda ch=ch: jax.jit(
            lambda p: jren.render(cfg, p, ja, cam, spec.time, "s2",
                                  spec.motion, spec.width, spec.height, bg,
                                  capacity=spec.capacity, channels=ch))(jp))
        if ch == 7:
            out["lists/idx"], out["lists/count"] = lists
        else:       # the same inputs: the same lists
            np.testing.assert_array_equal(lists[0], out["lists/idx"])
        planes = rc.PLANES if ch == 7 else ("image",)
        out.update({f"ch{ch}/{f}": np.asarray(o[f], np.float32)
                    for f in planes})
        for key in ("overflow", "overflow_max"):
            out[f"ch{ch}/{key}"] = np.asarray(o[key], np.int64).reshape(())
        if ch == 7:
            out["ch7/radii"] = np.asarray(o["radii"], np.int32)
            out["ch7/cpts_t"] = np.asarray(o["cpts_t"], np.float32)
    out["knn/idx"] = np.asarray(jax.jit(jren.find_knn)(jp, ja)[1], np.int16)
    out["knn/near_ties"] = near_ties(leaves["xyz"], leaves["c_xyz"])
    return out


def jax_vjp(spec: rc.Spec, scene) -> dict:
    cfg, jp, ja, cam, _ = scene
    bg = jnp.ones((3,))
    w = {f: jnp.asarray(v) for f, v in rc.plane_weights(spec).items()}

    def total(p):
        o = jren.render(cfg, p, ja, cam, spec.time, "s2", spec.motion,
                        spec.width, spec.height, bg, capacity=spec.capacity,
                        channels=7)
        return sum(jnp.sum(o[f] * w[f]) for f in rc.PLANES)

    return rc.sketch(grads_numpy(jax.jit(jax.grad(total))(jp)),
                     spec.sketch_seed)


def jax_step(spec: rc.Spec, scene) -> dict:
    cfg, jp, ja, _, leaves = scene
    n_m, n_v, n_f = spec.shape
    b = n_m * n_v * n_f
    bn = rc.batch_numpy(spec, leaves["c_xyz"])
    fov = float(np.deg2rad(33.9))
    cams = [jcam.Camera.from_c2w(jcam.orbit_camera(0, float(a), 2.0), fov,
                                 fov) for a in bn["azimuths"]]
    batch = {"camera": jcam.stack_cameras(cams),
             **{k: jnp.asarray(bn[k]) for k in
                ("times", "latent_idx", "mse_w", "gt_image", "gt_mask",
                 "guidance")}}
    fn = jstep.make_train_step(
        cfg, jstep.LossConfig(), "s2", spec.width, spec.height, n_m, n_v, n_f,
        capacity=spec.capacity,
        lpips_fn=jlpips.random_init_lpips(spec.lpips_seed), use_guidance=True)
    _, sub = jax.random.split(jax.random.PRNGKey(ARAP_KEY))
    taps = jnp.zeros((b, spec.n_gauss, 2))
    (loss, (metrics, _)), g = jax.jit(jax.value_and_grad(
        fn.loss_fn, has_aux=True))(jp, taps, ja, batch, sub,
                                   jnp.asarray(spec.step))
    arap_times = jax.random.uniform(jax.random.split(sub, b + n_m)[b], (8,))
    out = rc.sketch(grads_numpy(g), spec.sketch_seed)
    out["loss"] = np.float64(loss)
    out.update({f"metric/{k}": np.float64(v) for k, v in metrics.items()})
    out["arap_times"] = np.asarray(arap_times, np.float32)
    return out


MAKERS = {"frame": jax_frame, "vjp": jax_vjp, "step": jax_step}


def make(spec: rc.Spec, parts=rc.PARTS, folder: str = rc.GOLDEN,
         log=print) -> dict:
    """Write the parts' files for `spec` into `folder`; {part: seconds}."""
    orig = jdef.gather_small_cols
    jdef.gather_small_cols = exact_gather
    try:
        scene = jax_scene(spec)
        meta = {"spec": spec.to_json(),
                "scene_hash": rc.scene_hash(scene[4], spec),
                "made_by": "tests/make_torch_reference.py (dimo_tpu on the "
                           "CPU, LBS gather in its one-hot form)",
                "jax": jax.__version__}
        took = {}
        for part in parts:
            t0 = time.time()
            arrays = MAKERS[part](spec, scene)
            rc.write_vectors(rc.path_of(part, folder), dict(meta, part=part),
                             arrays)
            took[part] = time.time() - t0
            log(f"{part}: {took[part]:.1f} s, "
                f"{os.path.getsize(rc.path_of(part, folder))} bytes")
        return took
    finally:
        jdef.gather_small_cols = orig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", default=",".join(rc.PARTS))
    ap.add_argument("--out", default=rc.GOLDEN)
    args = ap.parse_args(argv)
    if jax.default_backend() != "cpu":
        sys.exit("run with JAX_PLATFORMS=cpu: the vectors are the CPU's")
    os.makedirs(args.out, exist_ok=True)
    make(rc.FULL, tuple(args.parts.split(",")), args.out)


if __name__ == "__main__":
    main()
