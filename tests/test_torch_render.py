"""End-to-end parity of the port's stage-2 render with the JAX package's,
on the CPU, with the weights carried across by `params_from_numpy`.

Scene: the flagship scene cut to ~2k Gaussians, 32 control points and a
latent of 8 (the JAX package's own `_flagship_scene`), with random small
TimeNet head weights so the deformation moves the points. Tolerance 1e-4
on image, alpha, depth and normal (the rasterizer's); 5e-4 for the
3-channel early-exit path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_scene
from dimo_tpu.models import deform as jdef
from dimo_tpu.models import renderer as jren
from dimo_tpu.ops import smallgather as jsg

from dimo_tpu_torch.io.convert import params_from_numpy
from dimo_tpu_torch.models import gaussians as TG
from dimo_tpu_torch.models import renderer as tren
from dimo_tpu_torch.scenes import flagship_numpy
from dimo_tpu_torch.utils import cameras as tcam

from test_torch_math import jax_to_numpy
from torch_parity import assert_close_except_cut_flips, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scenes():
    cfg_j, jp, ja, cam = _flagship_scene(n_gauss=2048, n_cpts=32,
                                         latent_dim=8, seed=3)
    d = jax_to_numpy(jp, ja)
    rng = np.random.RandomState(3)
    for k in ("pts_1_w", "rot_1_w"):
        d["timenet"][k] = (rng.randn(*d["timenet"][k].shape) * 0.02
                           ).astype(np.float32)
    jp = jp.replace(timenet={k: jnp.asarray(v) for k, v in d["timenet"].items()})
    tp, ta = params_from_numpy(d, device="cpu")
    cfg_t = TG.ModelConfig(sh_degree=cfg_j.sh_degree, latent_dim=8,
                           num_latents=4, capacity=2048, cpt_capacity=32)
    return (cfg_j, jp, ja), (cfg_t, tp, ta), cam


def test_flagship_numpy_is_the_reference_scene(scenes):
    (_, jp, _), _, _ = scenes
    leaves = flagship_numpy(2048, 32, seed=3)
    for k, v in leaves.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jp, k)), err_msg=k)


def _exact_jax_gather(table_t, idx):
    """The JAX package's plain one-hot reference of `gather_small_cols`
    (`_gather_cols_xla`), exact in float32."""
    out = jsg._gather_cols_xla(table_t.astype(jnp.float32), idx.reshape(-1))
    return out.reshape(table_t.shape[0], *idx.shape)


@pytest.mark.parametrize("width,height,channels,t", [
    (128, 64, 7, 0.35), (256, 256, 7, 0.6), (256, 256, 3, 0.0)])
def test_render_s2_matches_jax(scenes, monkeypatch, width, height, channels, t):
    # The reference's Pallas gather returns bf16 hi + lo (2^-17 relative):
    # ~3e-6 world units of position, which moves the flagship's sub-pixel
    # Gaussians' alpha by ~1e-4..1e-3. Run its plain one-hot reference
    # instead, so 1e-4 measures the render and not that split (the split
    # itself is held at its own tolerance in test_torch_deform.py).
    monkeypatch.setattr(jdef, "gather_small_cols", _exact_jax_gather)
    (cfg_j, jp, ja), (cfg_t, tp, ta), cam = scenes
    j = jren.render(cfg_j, jp, ja, cam, t, "s2", 1, width, height,
                    jnp.ones((3,)), capacity=1024, channels=channels)
    with torch.no_grad():      # the serving path records no graph
        out = tren.render(cfg_t, tp, ta, tcam.Camera(*cam), t, "s2", 1, width,
                          height, torch.ones(3), capacity=1024,
                          channels=channels)
    tol = 1e-4 if channels == 7 else 5e-4
    for f in ("image", "alpha", "depth", "normal"):
        # max_px_frac: besides alpha-cut flips, the flagship's sub-pixel
        # Gaussians evaluated one strip away from home carry u^2*cA terms
        # of ~2e3 in the Taylor-shifted quadratic, whose float32 rounding
        # (~2e-4 in power) both packages share but order differently; it
        # moves ~0.1% of pixels by up to ~1e-3 (measured: 12 of 8192 at
        # 128x64 on the same projected inputs).
        # depth (view z ~2) is held at the same relative tolerance
        ref = np.asarray(j[f])
        assert_close_except_cut_flips(out[f].numpy(), ref,
                                      tol * max(1.0, float(np.abs(ref).max())),
                                      f, max_px_frac=5e-3)
    # the deformation moved the points, and both sides moved them alike
    np.testing.assert_allclose(out["pts_t"].numpy(), np.asarray(j["pts_t"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["cpts_t"].numpy(), np.asarray(j["cpts_t"]),
                               rtol=0, atol=1e-5)
    assert float(np.abs(np.asarray(j["pts_t"]) - np.asarray(jp.xyz)).max()) > 1e-3
    assert int(out["overflow"]) == int(j["overflow"])
    assert float(out["alpha"].max()) > 0.5
    assert torch.equal(out["visibility_filter"], out["radii"] > 0)


def test_render_with_knn_cache_and_s1(scenes):
    _, (cfg_t, tp, ta), cam = scenes
    cam = tcam.Camera(*cam)
    knn = tren.find_knn(tp, ta)
    a = tren.render(cfg_t, tp, ta, cam, 0.2, "s2", 0, 128, 64, torch.ones(3))
    b = tren.render(cfg_t, tp, ta, cam, 0.2, "s2", 0, 128, 64, torch.ones(3),
                    knn_cache=knn)
    assert torch.equal(a["image"], b["image"])
    s1 = tren.render(cfg_t, tp, ta, cam, 0.2, "s1", 0, 128, 64, torch.ones(3))
    assert s1["image"].shape == (3, 64, 128)
    assert torch.isfinite(s1["image"]).all()


# ---------------------------------------------------------------------------
# The render pass (`render_batch`): R jobs along a leading render axis give
# what R one-job renders give.

import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402

from dimo_tpu_torch.ops.rasterizer import strips as tstrips  # noqa: E402
from dimo_tpu_torch.ops.rasterizer import tiles as ttiles  # noqa: E402
from dimo_tpu_torch.scenes import flagship_scene  # noqa: E402
from dimo_tpu_torch.train import optim as toptim  # noqa: E402

PASS_W, PASS_H, PASS_CAP = 256, 192, 256
PASS_TIMES, PASS_LATENTS = [0.3, 0.5, 0.8], [0, 3, 1]
R1_GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                         "render_r1.json")


def pass_scene():
    """A 3,000-Gaussian flagship scene whose TimeNet moves the points, with
    80 Gaussians grown to a medium and a big footprint, and three cameras:
    near (that render bins mediums and bigs), mid and far (nothing but
    small Gaussians)."""
    cfg, p, aux, _ = flagship_scene(3000, 48, latent_dim=8, seed=2,
                                    device="cpu")
    with torch.no_grad():
        p.timenet.pts_1.weight.normal_(
            0, 0.02, generator=torch.Generator().manual_seed(5))
        p.timenet.rot_1.weight.normal_(
            0, 0.02, generator=torch.Generator().manual_seed(6))
        p.scaling[:40] += 3.2
        p.scaling[40:80] += 4.3
    for v in toptim.named_leaves(p).values():
        v.requires_grad_(True)
    fov = float(np.deg2rad(33.9))
    cams = [tcam.Camera.from_c2w(tcam.orbit_camera(e, a, d), fov, fov)
            for e, a, d in ((0, 30, 2.0), (-20, 60, 2.5), (10, 200, 90.0))]
    return cfg, p, aux, cams


def tier_counts(lists_args):
    """(mediums, bigs) of each render, from `build_strip_lists`' inputs, by
    the binning's footprint rule (within 2 x 2 strips: small; within 5 x
    5: medium; else big)."""
    mean2d, radius, _, ok, h, w, _ = lists_args
    nrows, ncols = tstrips.num_strips(h, w)
    f = lambda v, s: torch.floor(v / s)  # noqa: E731
    cmin, cmax = f(mean2d[..., 0] - radius, 32), f(mean2d[..., 0] + radius, 32)
    rmin, rmax = f(mean2d[..., 1] - radius, 32), f(mean2d[..., 1] + radius, 32)
    alive = (ok & (radius > 0) & (cmax >= 0) & (cmin <= ncols - 1)
             & (rmax >= 0) & (rmin <= nrows - 1))
    dc = cmax.clamp(0, ncols - 1) - cmin.clamp(0, ncols - 1)
    dr = rmax.clamp(0, nrows - 1) - rmin.clamp(0, nrows - 1)
    small = (dc < 2) & (dr < 2)
    med = alive & ~small & (dc < 5) & (dr < 5)
    big = alive & ~small & ~med
    return med.sum(-1).tolist(), big.sum(-1).tolist()


def weighted_sum(out: dict, lead: bool) -> torch.Tensor:
    """A scalar of the four planes that weighs every pixel differently."""
    total = 0.0
    for f in ("image", "depth", "normal", "alpha"):
        x = out[f]
        shape = x.shape[1:] if lead else x.shape
        w = 1.0 + torch.arange(int(np.prod(shape))).reshape(shape) % 7
        total = total + (x * w).sum()
    return total


def run_and_grads(fn, params, tap_n=None):
    """fn(tap) -> (outputs, loss); returns (outputs, {leaf: grad}, tap grad)."""
    leaves = toptim.named_leaves(params)
    for v in leaves.values():
        v.grad = None
    tap = None if tap_n is None else torch.zeros((tap_n, 2),
                                                 requires_grad=True)
    out, loss = fn(tap)
    loss.backward()
    grads = {k: v.grad.clone() for k, v in leaves.items()
             if v.grad is not None and v.numel()}
    return out, grads, None if tap is None else tap.grad


def record_lists(monkeypatch):
    """Wraps `build_strip_lists`: [(args, lists)] of every call."""
    calls, real = [], tstrips.build_strip_lists

    def rec(*args):
        lists = real(*args)
        calls.append((args, lists))
        return lists
    monkeypatch.setattr(tstrips, "build_strip_lists", rec)
    return calls


@pytest.mark.parametrize("stage", ["s2", "s1"])
def test_render_batch_matches_one_job_renders(monkeypatch, stage):
    """Three jobs (cameras, times, latents all different) in one pass give
    each job's one-job render: the strip lists, counts and overflow
    exactly, the planes to 1e-6, every leaf's gradient of a scalar of the
    planes to 1e-5 of its largest entry; in s1 the `mean2d_tap` on the
    last job too."""
    cfg, p, aux, cams = pass_scene()
    n = p.xyz.shape[0]
    tap_n = n if stage == "s1" else None
    calls = record_lists(monkeypatch)

    def batched(tap):
        out = tren.render_batch(cfg, p, aux, cams, PASS_TIMES, stage,
                                PASS_LATENTS, PASS_W, PASS_H, torch.ones(3),
                                capacity=PASS_CAP, mean2d_tap=tap)
        return out, weighted_sum(out, lead=True)

    def one_by_one(tap):
        outs = [tren.render(cfg, p, aux, cams[i], PASS_TIMES[i], stage,
                            PASS_LATENTS[i], PASS_W, PASS_H, torch.ones(3),
                            capacity=PASS_CAP,
                            mean2d_tap=tap if i == 2 else None)
                for i in range(3)]
        return outs, sum(weighted_sum(o, lead=False) for o in outs)

    ob, gb, tb = run_and_grads(batched, p, tap_n)
    (bargs, blists), = calls
    os_, g1, t1 = run_and_grads(one_by_one, p, tap_n)
    if stage == "s2":
        # the pass holds a render with mediums and bigs and one with neither
        meds, bigs = tier_counts(bargs)
        assert meds[0] > 0 and bigs[0] > 0 and meds[2] == bigs[2] == 0, \
            (meds, bigs)
    for i, (_, lists) in enumerate(calls[1:]):
        for f in ("idx", "count", "overflow", "overflow_max"):
            # a one-job render bins along a leading axis of one
            assert torch.equal(getattr(blists, f)[i], getattr(lists, f)[0]), f
        for f in ("image", "depth", "normal", "alpha"):
            torch.testing.assert_close(ob[f][i], os_[i][f], rtol=0,
                                       atol=1e-6)
        for f in ("radii", "visibility_filter", "overflow", "overflow_max",
                  "pts_t", "cpts_t"):
            torch.testing.assert_close(ob[f][i], os_[i][f], rtol=0, atol=0)
    assert blists.overflow.sum() > 0          # the capacity bites
    assert gb.keys() == g1.keys() and "timenet.trunk.0.weight" in gb
    for k in g1:
        scale = float(g1[k].abs().max())
        assert scale > 0, k
        assert float((gb[k] - g1[k]).abs().max()) <= 1e-5 * scale, k
    if stage == "s1":
        torch.testing.assert_close(tb, t1, rtol=0,
                                   atol=1e-5 * float(t1.abs().max()))
        assert float(t1.abs().max()) > 0


# s1's grown Gaussians cover the near and mid cameras' frames whole, where
# every gradient is zero: its one-job renders look from further away
R1_S1_VIEWS = ((20, 300, 15.0), (0, 30, 30.0))


def r1_fingerprint() -> dict:
    """sha256 of every output and leaf gradient of one-job renders of the
    pass scene: s2 and s1 (with the tap) at 7 channels, and a 3-channel
    frame under no_grad. Every gradient and the tap's is nonzero, so the
    digests hold the backward."""
    cfg, p, aux, cams = pass_scene()
    fov = float(np.deg2rad(33.9))
    views = {"s2": cams[:2],
             "s1": [tcam.Camera.from_c2w(tcam.orbit_camera(*v), fov, fov)
                    for v in R1_S1_VIEWS]}
    out = {}

    def digest(key, x):
        out[key] = hashlib.sha256(
            x.detach().contiguous().numpy().tobytes()).hexdigest()
    for stage in ("s2", "s1"):
        for i in range(2):
            tap_n = p.xyz.shape[0] if stage == "s1" else None

            def one(tap):
                o = tren.render(cfg, p, aux, views[stage][i], PASS_TIMES[i],
                                stage, PASS_LATENTS[i], PASS_W, PASS_H,
                                torch.ones(3), capacity=PASS_CAP,
                                mean2d_tap=tap)
                return o, weighted_sum(o, lead=False)
            o, grads, tap = run_and_grads(one, p, tap_n)
            for k, g in [*grads.items(), ("tap", tap)]:
                assert g is None or float(g.abs().max()) > 0, (stage, i, k)
            for f in sorted(o):
                digest(f"{stage}{i}.{f}", o[f])
            for k in sorted(grads):
                digest(f"{stage}{i}.grad.{k}", grads[k])
            if tap is not None:
                digest(f"{stage}{i}.tap", tap)
        with torch.no_grad():
            o = tren.render(cfg, p, aux, views[stage][0], 0.1, stage, 1,
                            PASS_W, PASS_H, torch.ones(3), capacity=PASS_CAP,
                            channels=3)
        digest(f"{stage}.ch3.image", o["image"])
    return out


def test_one_job_render_is_the_per_job_render_bit_for_bit():
    """`render` (the pass at R = 1) gives the bits the per-job render gave
    before the pass existed: `golden/render_r1.json` holds that render's
    digests of the same outputs and gradients, on this CPU and one
    thread."""
    with open(R1_GOLDEN) as f:
        want = json.load(f)
    got = r1_fingerprint()
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []


def test_one_job_pass_is_the_render():
    """`render_batch` of one job is `render`, bit for bit, and the jobs of
    a pass of three are too."""
    cfg, p, aux, cams = pass_scene()
    with torch.no_grad():
        one = tren.render_batch(cfg, p, aux, cams[1:2], PASS_TIMES[1:2],
                                "s2", PASS_LATENTS[1:2], PASS_W, PASS_H,
                                torch.ones(3), capacity=PASS_CAP)
        three = tren.render_batch(cfg, p, aux, cams, PASS_TIMES, "s2",
                                  PASS_LATENTS, PASS_W, PASS_H,
                                  torch.ones(3), capacity=PASS_CAP)
        single = tren.render(cfg, p, aux, cams[1], PASS_TIMES[1], "s2",
                             PASS_LATENTS[1], PASS_W, PASS_H, torch.ones(3),
                             capacity=PASS_CAP)
    for k, v in single.items():
        assert one[k].shape == (1, *v.shape) and torch.equal(one[k][0], v), k
        assert torch.equal(three[k][1], v), k


def test_render_batch_refuses_what_a_pass_cannot_hold():
    cfg, p, aux, cams = pass_scene()

    class Mesh:               # a two-rank spatial mesh (only its size is read)
        size, rank = 2, 0
    kw = dict(capacity=PASS_CAP, sp=Mesh())
    with torch.no_grad():
        with pytest.raises(ValueError, match="spatial sharding takes one"):
            tren.render_batch(cfg, p, aux, cams[:2], PASS_TIMES[:2], "s2",
                              PASS_LATENTS[:2], PASS_W, PASS_H,
                              torch.ones(3), **kw)
        wide = tcam.Camera.from_c2w(tcam.orbit_camera(0, 30, 2.0), 1.0, 1.0)
        with pytest.raises(ValueError, match="share a field of view"):
            tren.render_batch(cfg, p, aux, [cams[0], wide], PASS_TIMES[:2],
                              "s2", PASS_LATENTS[:2], PASS_W, PASS_H,
                              torch.ones(3), capacity=PASS_CAP)
        with pytest.raises(ValueError, match="one of each a job"):
            tren.render_batch(cfg, p, aux, cams, PASS_TIMES[:2], "s2",
                              PASS_LATENTS, PASS_W, PASS_H, torch.ones(3))


def bin_inputs(kind: str, seed: int, n: int = 600):
    """(mean2d, radius, depth, ok) of one render on a 256 x 256 frame of
    32-px bins: "small" only, "medium" (small and medium footprints) or
    "big" (all three tiers)."""
    g = torch.Generator().manual_seed(seed)
    mean2d = torch.rand((n, 2), generator=g) * 300 - 20
    radius = torch.rand((n,), generator=g) * 14 + 1
    if kind in ("medium", "big"):
        radius[:30] = 34 + torch.rand((30,), generator=g) * 26
    if kind == "big":
        radius[30:40] = 120 + torch.rand((10,), generator=g) * 100
    depth = torch.rand((n,), generator=g) * 3 + 1
    depth[::7] = depth[3]                     # ties in depth
    ok = torch.rand((n,), generator=g) > 0.05
    return mean2d, radius, depth, ok


@pytest.mark.parametrize("windma", [0, 1], ids=["gather", "windma"])
@pytest.mark.parametrize("kinds", [("big", "small", "medium"),
                                   ("small", "small", "small"),
                                   ("medium", "big", "medium")],
                         ids=["mixed", "all-small", "no-small-only"])
def test_build_bin_lists_leading_axis_is_each_renders_own(monkeypatch,
                                                          windma, kinds):
    """`build_bin_lists` over a leading render axis gives each render the
    lists, counts and overflow it gets alone, exactly: with a render that
    has no medium or no big beside renders that have them, at a capacity
    that overflows, through both window readouts."""
    monkeypatch.setattr(ttiles, "WINDMA", windma)
    ins = [bin_inputs(k, seed) for seed, k in enumerate(kinds)]
    stacked = [torch.stack(x) for x in zip(*ins)]
    args = (8, 8, 32, 32, 24)
    meds, bigs = tier_counts((*stacked, 256, 256, None))
    assert [(m > 0, b > 0) for m, b in zip(meds, bigs)] == [
        (k != "small", k == "big") for k in kinds], (meds, bigs)
    got = ttiles.build_bin_lists(*stacked, *args)
    assert got.idx.shape == (3, 64, 24) and got.overflow.shape == (3,)
    for i, one in enumerate(ins):
        want = ttiles.build_bin_lists(*one, *args)
        for f in want._fields:
            assert torch.equal(getattr(got, f)[i], getattr(want, f)), (i, f)
    assert int(got.overflow.sum()) > 0
