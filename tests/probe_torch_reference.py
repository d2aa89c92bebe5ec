"""Where the port and the JAX package part at full width: the flagship
frame of `dimo_tpu_torch/reference_check.py` taken apart on the CPU.

    JAX_PLATFORMS=cpu python tests/probe_torch_reference.py [PROBE ...]

Probes (all but `card` by default; each prints its numbers):

* stages: the frame's stages, `dimo_tpu` against the port (TimeNet, KNN,
  LBS, projection, strip lists, coefficient table);
* selfswap: the reference's own strip lists, its render's code run op by
  op (`jax.disable_jit`), against the lists its compiled render made
  (`tests/golden/torch_reference_frame.npz`);
* strip_vjp: the compositor's gradient to the coefficient table (image
  weights from RandomState(5)), the port in float32 and float64 and the
  reference, per lane, on the frame's own table and lists;
* image_vjp: the gradient of the weighted image alone to every leaf,
  port against reference (relative L2);
* tie_jitter: the port's LPIPS-on step with every binning depth moved by
  one float32 step at random, against the port's step (relative L2);
* card: the card's outputs that `chip_smoke.py --phase reference` kept
  (`build/reference_card.npz`) against the CPU port's.
"""
from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import make_torch_reference as mk
from dimo_tpu.models import deform as jdef
from dimo_tpu.models import gaussians as JG
from dimo_tpu.models import renderer as jren
from dimo_tpu.models import timenet as jtn
from dimo_tpu.ops.rasterizer import projection as jproj
from dimo_tpu.ops.rasterizer import strips as jstrips
from dimo_tpu.ops.rasterizer.composite_strips import composite_strips as jcomp

from dimo_tpu_torch import reference_check as rc
from dimo_tpu_torch.models import deform
from dimo_tpu_torch.models import gaussians as G
from dimo_tpu_torch.models.renderer import find_knn, render
from dimo_tpu_torch.ops.rasterizer import composite_strips as cs
from dimo_tpu_torch.ops.rasterizer import projection, strips
from dimo_tpu_torch.ops.rasterizer.api import camera_tensors
from dimo_tpu_torch.train.step import init_state

SPEC = rc.FULL
SIZE = SPEC.width


def jax_stages(jp, ja, cam):
    lat = JG.sample_latent(jp, SPEC.motion, None)
    d_xyz, d_rot = jtn.apply_timenet(jp.timenet, jp.c_xyz, SPEC.time, lat)
    dist, idx = jren.find_knn(jp, ja)
    m3, rot = jdef.lbs_blend(jp.xyz, jp.rotation, jp.c_xyz, d_xyz, d_rot,
                             JG.get_c_radius(jp, "s2"), idx, dist)
    pr = jproj.project(m3, JG.get_scaling(jp, "s2"), rot, JG.get_opacity(jp),
                       JG.get_features(jp), cam.world_view, cam.full_proj,
                       cam.campos, cam.tan_fovx, cam.tan_fovy, SIZE, SIZE,
                       valid=ja.active)
    lists = jstrips.build_strip_lists(pr.mean2d, pr.cull_radius, pr.depth,
                                      pr.in_frustum, SIZE, SIZE, SPEC.capacity)
    table = jstrips.coef_table(pr.mean2d, pr.conic, JG.get_opacity(jp),
                               pr.color, pr.depth, pr.normal, SIZE, SIZE)
    return dict(d_xyz=d_xyz, knn=idx, means3d=m3, rotations=rot, pr=pr,
                lists=lists, table=table)


@torch.no_grad()
def port_stages(p, aux, cam, spec: rc.Spec = SPEC):
    d_xyz, d_rot = p.timenet(p.c_xyz, spec.time,
                             G.sample_latent(p, spec.motion))
    dist, idx = find_knn(p, aux)
    m3, rot = deform.lbs_blend(p.xyz, p.rotation, p.c_xyz, d_xyz, d_rot,
                               G.get_c_radius(p, "s2"), idx, dist)
    wv, fp, cp = camera_tensors(cam, "cpu")
    size = spec.width
    pr = projection.project(m3, G.get_scaling(p, "s2"), rot, G.get_opacity(p),
                            G.get_features(p), wv, fp, cp, float(cam.tan_fovx),
                            float(cam.tan_fovy), size, size, valid=aux.active)
    lists = strips.build_strip_lists(pr.mean2d, pr.cull_radius, pr.depth,
                                     pr.in_frustum, size, size, spec.capacity)
    table = strips.coef_table(pr.mean2d, pr.conic, G.get_opacity(p), pr.color,
                              pr.depth, pr.normal, size, size)
    return dict(d_xyz=d_xyz, knn=idx, means3d=m3, rotations=rot, pr=pr,
                lists=lists, table=table)


def table_grads(table, lists, size: int) -> tuple:
    """The gradient of the image weighted by RandomState(5) draws to the
    six power-quadratic lanes of the coefficient table, summed per
    Gaussian (N, 6):
    the port's plain K3 in float32 and in float64, and the reference's
    Pallas VJP (interpret mode), on the same table and lists."""
    w = np.random.RandomState(5).rand(3, size, size).astype(np.float32)

    def port(dtype):
        tb = table.to(dtype)
        tfin = cs.composite_strips_plain(tb, lists.idx, lists.count, size,
                                         size)[-1]
        gout = torch.zeros((8, size, size), dtype=dtype)
        gout[:3] = torch.from_numpy(w).to(dtype)
        gout[7] = gout[:3].sum(0)           # image = out + T_final * bg
        rows = cs.composite_strips_bwd_plain(tb, lists.idx, lists.count, tfin,
                                             gout).double()
        out = torch.zeros((table.shape[0], 16), dtype=torch.float64)
        out.index_add_(0, lists.idx.reshape(-1).long(), rows.reshape(-1, 16))
        return out.numpy()[:-1, :6]

    jl = jstrips.StripLists(jnp.asarray(lists.idx.numpy()),
                            jnp.asarray(lists.count.numpy()),
                            jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32))

    def image_sum(tb):
        bufs = jstrips.build_buffers(tb, jl, size, size)
        planes = jstrips.reassemble(jcomp(bufs.slabs, bufs.evalid,
                                          bufs.count), bufs.order, size, size)
        return jnp.sum((planes[0:3] + planes[-1][None]) * jnp.asarray(w))

    ref = np.asarray(jax.jit(jax.grad(image_sum))(
        jnp.asarray(table.numpy())), np.float64)[:-1, :6]
    return port(torch.float32), port(torch.float64), ref


def lane_rel(a, b, lane: int) -> float:
    return float(np.linalg.norm(a[:, lane] - b[:, lane])
                 / np.linalg.norm(b[:, lane]))


def max_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max(initial=0.0))


def probe_stages(ctx):
    j, t = ctx["jax"](), ctx["port"]()
    for k in ("d_xyz", "knn", "means3d", "rotations", "table"):
        print(f"stages {k}: max |jax - port| {max_err(j[k], t[k])}")
    for f in ("mean2d", "conic", "depth", "normal", "radius"):
        print(f"stages projection {f}: max |jax - port| "
              f"{max_err(getattr(j['pr'], f), getattr(t['pr'], f))}")
    rows = rc.list_rows(np.asarray(j["lists"].idx),
                        np.asarray(j["lists"].count),
                        t["lists"].idx.numpy(), t["lists"].count.numpy(),
                        t["pr"].depth.numpy())
    print("stages lists (op by op):", [(r["what"], r["value"]) for r in rows])


def probe_selfswap(ctx):
    with jax.disable_jit():
        j = ctx["jax"]()
    ref = rc.read_vectors(rc.path_of("frame"))[1]
    rows = rc.list_rows(ref["lists/idx"], ref["lists/count"],
                        np.asarray(j["lists"].idx),
                        np.asarray(j["lists"].count),
                        np.asarray(j["pr"].depth))
    print("selfswap the reference op by op against its compiled render:",
          [(r["what"], r["value"]) for r in rows])


def probe_strip_vjp(ctx):
    t = ctx["port"]()
    p32, p64, ref = table_grads(t["table"], t["lists"], SIZE)
    print("strip_vjp relative L2 to float64 by lane, port:",
          [f"{lane_rel(p32, p64, i):.2e}" for i in range(6)], "reference:",
          [f"{lane_rel(ref, p64, i):.2e}" for i in range(6)])


def probe_image_vjp(ctx):
    cfg, jp, ja, cam, _ = ctx["scene"]
    w = np.random.RandomState(5).rand(3, SIZE, SIZE).astype(np.float32)
    jg = mk.grads_numpy(jax.jit(jax.grad(lambda p: jnp.sum(jren.render(
        cfg, p, ja, cam, SPEC.time, "s2", SPEC.motion, SIZE, SIZE,
        jnp.ones((3,)), capacity=SPEC.capacity)["image"] * w)))(jp))
    cfg_t, p, aux, tcam = rc.port_scene(SPEC, "cpu")
    init_state(p, aux)
    out = render(cfg_t, p, aux, tcam, SPEC.time, "s2", SPEC.motion, SIZE, SIZE,
                 torch.ones(3), capacity=SPEC.capacity)
    torch.sum(out["image"] * torch.from_numpy(w)).backward()
    tg = rc.port_grads(p)
    print("image_vjp relative L2:", {
        k: f"{np.linalg.norm(tg[k] - jg[k]) / np.linalg.norm(jg[k]):.2e}"
        for k in ("rotation", "scaling", "xyz", "opacity", "features_dc",
                  "c_xyz", "latent.codes")})


def probe_tie_jitter(ctx):
    times = rc.read_vectors(rc.path_of("step"))[1]["arap_times"]
    _, _, base = rc.port_step(SPEC, "cpu", times)
    orig = strips.build_strip_lists
    gen = torch.Generator().manual_seed(1)

    def jittered(mean2d, radius, depth, ok, height, width, capacity):
        s = torch.randint(-1, 2, depth.shape, generator=gen).to(depth.dtype)
        moved = torch.where(s == 0, depth, torch.nextafter(depth, depth + s))
        return orig(mean2d, radius, moved, ok, height, width, capacity)

    strips.build_strip_lists = jittered
    try:
        _, _, moved = rc.port_step(SPEC, "cpu", times)
    finally:
        strips.build_strip_lists = orig
    print("tie_jitter relative L2:", {
        k: f"{np.linalg.norm(moved[k] - base[k]) / np.linalg.norm(base[k]):.2e}"
        for k in ("rotation", "scaling", "xyz", "opacity", "c_xyz")})


def probe_card(ctx):
    card = np.load(os.path.join(rc.GOLDEN, "..", "..", "build",
                                "reference_card.npz"))
    keep = {}
    rc.check("cpu", keep=keep, log=lambda *_: None)
    print("card pts_t: max |card - cpu|",
          max_err(card["frame7/pts_t"], keep["frame7"]["pts_t"]))
    for part in ("vjp", "step"):
        rel = {k: np.linalg.norm(card[f"{part}/{k}"] - v)
               / np.linalg.norm(v) for k, v in keep[part].items()
               if np.linalg.norm(v)}
        print(f"card {part} gradients, relative L2 card against cpu: "
              f"{min(rel.values()):.2e} to {max(rel.values()):.2e}; "
              f"rotation {rel['rotation']:.2e}")


PROBES = {"stages": probe_stages, "selfswap": probe_selfswap,
          "strip_vjp": probe_strip_vjp, "image_vjp": probe_image_vjp,
          "tie_jitter": probe_tie_jitter, "card": probe_card}


def main(argv) -> None:
    jdef.gather_small_cols = mk.exact_gather
    scene = mk.jax_scene(SPEC)
    _, jp, ja, cam, _ = scene
    port = rc.port_scene(SPEC, "cpu")
    ctx = {"scene": scene, "jax": lambda: jax_stages(jp, ja, cam),
           "port": lambda: port_stages(port[1], port[2], port[3])}
    for name in argv or [p for p in PROBES if p != "card"]:
        PROBES[name](ctx)


if __name__ == "__main__":
    main(sys.argv[1:])
