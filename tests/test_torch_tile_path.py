"""The tile-compositor path as a whole: the port's `rasterize_tiles` against
the JAX package's own sequence, and against the port's strip path and
dense oracle, on the CPU.

The reference side is `scripts/profile_composite.py:18-33` restated with
`dimo_tpu` functions (project -> build_tile_lists -> pack_attrs ->
gather_rows -> composite_pallas.composite, Pallas in interpret mode as
tests/conftest.py forces) and composed as `api.py:138-143` composes a
render. Tolerances:
  * image, alpha, depth, normal vs the reference: 1e-4 (the float32
    cancellation of the expanded tile-local quadratic that both packages
    carry, see test_torch_composite_tiles.py; projection rounds
    differently), except the rare alpha-cut flip (tests/torch_parity.py);
  * gradients of a weighted sum of all four outputs w.r.t. means, scales,
    quats, opacities and SH vs `jax.grad` of the same sum: 1e-3 relative
    L2 per input;
  * tile path vs the port's strip path (`rasterize`) and dense oracle
    (`rasterize_dense`) on a scene neither list overflows: 1e-4, depth
    2e-4 (`tests/test_rasterizer.py:44-47`); gradients 1e-3 relative L2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.ops.rasterizer import composite_pallas as jcp
from dimo_tpu.ops.rasterizer import gather as jgather
from dimo_tpu.ops.rasterizer import projection as jproj
from dimo_tpu.ops.rasterizer import tiles as jtiles

from dimo_tpu_torch.models import gaussians as TG
from dimo_tpu_torch.models import renderer as tren
from dimo_tpu_torch.ops.rasterizer import rasterize, rasterize_dense
from dimo_tpu_torch.ops.rasterizer import tile_path
from dimo_tpu_torch.scenes import flagship_scene
from dimo_tpu_torch.train import optim
from dimo_tpu_torch.utils import cameras as tcam

from test_torch_composite import CAM, scene
from torch_parity import assert_close_except_cut_flips, one_torch_thread  # noqa: F401

FIELDS = ("image", "alpha", "depth", "normal")
NAMES = ("means", "scales", "quats", "opacities", "sh")
BG = np.array([1.0, 0.5, 0.25], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(width, height):
    """A fixed smooth weight per output plane, so that the sum has a
    gradient in every channel and pixel."""
    rng = np.random.RandomState(11)
    return {f: rng.uniform(0.5, 1.5, (c, height, width)).astype(np.float32)
            for f, c in zip(FIELDS, (3, 1, 1, 3))}


def _jax_tile_render(g, width, height, capacity):
    """The reference's tile path: outputs and the gradient of the weighted
    sum w.r.t. the five inputs."""
    w = {f: jnp.asarray(v) for f, v in _weights(width, height).items()}
    nrows, ncols = jtiles.num_tiles(height, width)

    def outputs(means, scales, quats, opac, sh):
        p = jproj.project(means, scales, quats, opac, sh,
                          jnp.asarray(CAM.world_view),
                          jnp.asarray(CAM.full_proj), jnp.asarray(CAM.campos),
                          CAM.tan_fovx, CAM.tan_fovy, width, height)
        lists = jtiles.build_tile_lists(
            jax.lax.stop_gradient(p.mean2d), p.cull_radius,
            jax.lax.stop_gradient(p.depth), p.in_frustum, height, width,
            capacity)
        attrs = jtiles.pack_attrs(p.mean2d, p.conic, opac, p.color, p.depth,
                                  p.normal, radius=p.cull_radius)
        packed = jgather.gather_rows(attrs, lists.idx)
        out, tfin = jcp.composite(packed, lists.count.reshape(nrows, ncols),
                                  height, width)
        res = {"image": out[0:3] + tfin[None] * jnp.asarray(BG)[:, None, None],
               "alpha": (1.0 - tfin)[None], "depth": out[3:4],
               "normal": out[4:7]}
        return res, lists.overflow

    def loss(*a):
        res, overflow = outputs(*a)
        return sum(jnp.sum(res[f] * w[f]) for f in FIELDS), (res, overflow)

    (_, (res, overflow)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*map(jnp.asarray, g))
    return ({f: np.asarray(v) for f, v in res.items()}, int(overflow),
            [np.asarray(x) for x in grads])


def _torch_render(fn, g, width, height, **kw):
    """A port render and the gradient of the same weighted sum."""
    ins = [_t(a).requires_grad_(True) for a in g]
    out = fn(*ins, tcam.Camera(*CAM), width, height, _t(BG), **kw)
    w = _weights(width, height)
    loss = sum((getattr(out, f) * _t(w[f])).sum() for f in FIELDS)
    loss.backward()
    return out, [t.grad.numpy() for t in ins]


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@pytest.mark.parametrize("width,height,capacity,n", [(128, 64, 64, 120),
                                                     (256, 128, 64, 400)])
def test_tile_path_matches_the_reference_sequence(width, height, capacity, n):
    g = scene(n, 5)
    ref, overflow, ref_grads = _jax_tile_render(g, width, height, capacity)
    out, grads = _torch_render(tile_path.rasterize_tiles, g, width, height,
                               capacity=capacity)
    assert int(out.overflow) == overflow
    assert float(out.alpha.detach().max()) > 0.5
    for f in FIELDS:
        assert_close_except_cut_flips(getattr(out, f).detach().numpy(),
                                      ref[f], 1e-4, f)
    for name, got, want in zip(NAMES, grads, ref_grads):
        assert _rel(got, want) <= 1e-3, (name, _rel(got, want))


@pytest.mark.parametrize("width,height", [(128, 64), (256, 128)])
def test_tile_path_matches_strip_path_and_dense_oracle(width, height):
    g = scene(60, 7)
    tiles_out, tiles_g = _torch_render(tile_path.rasterize_tiles, g, width,
                                       height, capacity=64)
    strips_out, strips_g = _torch_render(rasterize, g, width, height,
                                         capacity=64)
    dense_out, dense_g = _torch_render(rasterize_dense, g, width, height)
    assert int(tiles_out.overflow) == 0 and int(strips_out.overflow) == 0
    assert float(tiles_out.alpha.detach().max()) > 0.5
    for other, what in ((strips_out, "strips"), (dense_out, "dense")):
        for f in FIELDS:
            assert_close_except_cut_flips(
                getattr(tiles_out, f).detach().numpy(),
                getattr(other, f).detach().numpy(),
                2e-4 if f == "depth" else 1e-4, f"{f} vs {what}")
    for name, got, a, b in zip(NAMES, tiles_g, strips_g, dense_g):
        assert _rel(got, a) <= 1e-3, (name, "vs strips", _rel(got, a))
        assert _rel(got, b) <= 1e-3, (name, "vs dense", _rel(got, b))
    assert torch.equal(tiles_out.radii, strips_out.radii)


@pytest.mark.parametrize("channels", [3, 4])
def test_tile_path_infer_channels(channels):
    g = [_t(a) for a in scene(120, 5)]
    cam, bg = tcam.Camera(*CAM), _t(BG)
    full = tile_path.rasterize_tiles(*g, cam, 128, 64, bg, capacity=64)
    out = tile_path.rasterize_tiles(*g, cam, 128, 64, bg, capacity=64,
                                    channels=channels)
    assert torch.equal(out.image, full.image)
    assert torch.equal(out.alpha, full.alpha)
    assert not out.normal.any()
    if channels == 3:
        assert not out.depth.any()
    else:
        assert torch.equal(out.depth, full.depth)


def test_tile_path_rejects_partial_tiles_and_masks_invalid():
    g = [_t(a) for a in scene(60, 7)]
    cam, bg = tcam.Camera(*CAM), _t(BG)
    with pytest.raises(ValueError, match="multiple"):
        tile_path.rasterize_tiles(*g, cam, 100, 64, bg)
    with pytest.raises(ValueError, match="channels"):
        tile_path.rasterize_tiles(*g, cam, 128, 64, bg, channels=5)
    none = tile_path.rasterize_tiles(*g, cam, 128, 64, bg,
                                     valid=torch.zeros(60, dtype=torch.bool))
    assert not none.alpha.any()
    assert torch.equal(none.image, bg[:, None, None].expand(3, 64, 128))


def test_render_tiles_is_the_stage2_deformation_in_front_of_the_path():
    """`render_tiles` = latent -> TimeNet -> LBS blend -> `rasterize_tiles`:
    equal to the strip render's deformed points fed to the tile path, and
    differentiable down to the TimeNet and the latent codes."""
    cfg, params, aux, cam = flagship_scene(1024, 32, 8, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for lin in (params.timenet.pts_1, params.timenet.rot_1):
            lin.weight.copy_(torch.randn(lin.weight.shape, generator=gen) * 0.02)
    leaves = optim.named_leaves(params)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    knn = tren.find_knn(params, aux)
    bg = torch.ones(3)
    out = tile_path.render_tiles(cfg, params, aux, cam, 0.35, 1, 128, 64, bg,
                                 knn, capacity=256)
    strip = tren.render(cfg, params, aux, cam, 0.35, "s2", 1, 128, 64, bg,
                        knn_cache=knn, capacity=256)
    direct = tile_path.rasterize_tiles(
        strip["pts_t"], TG.get_scaling(params, "s2"),
        tile_path.deform_mod.lbs_blend(
            params.xyz, params.rotation, params.c_xyz,
            *params.timenet(params.c_xyz, 0.35, TG.sample_latent(params, 1)),
            TG.get_c_radius(params, "s2"), knn[1], knn[0])[1],
        TG.get_opacity(params), TG.get_features(params), cam, 128, 64, bg,
        capacity=256, valid=aux.active)
    assert torch.equal(out.image, direct.image)
    assert float(out.alpha.detach().max()) > 0.5
    (out.image.sum() + out.depth.sum()).backward()
    moved = {k for k, leaf in leaves.items() if leaf.grad is not None
             and torch.isfinite(leaf.grad).all()
             and float(leaf.grad.abs().sum()) > 0}
    assert {"xyz", "scaling", "rotation", "opacity", "features_dc", "c_xyz",
            "c_radius", "latent.codes"} <= moved, sorted(moved)
    assert any(k.startswith("timenet.") for k in moved), sorted(moved)
