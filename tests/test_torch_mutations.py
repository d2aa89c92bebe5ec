"""The densify / prune / FPS mutations of the port's Gaussian store against
`dimo_tpu.models.gaussians`, on the CPU.

State: capacity 64 with 40 active slots (holes punched into the active
mask so free slots are not one tail block), SH degree 1, random scales,
rotations, opacities, densification statistics and Adam moments, all from
numpy seeds and carried into both packages. The split's noise is JAX's
own draw (`jax.random.normal` of the split keys) handed to the port.

Tolerances: masks, slot assignment, copied rows and moments exactly;
1e-6 where a value goes through `log`/`exp`/`sigmoid` (the two libraries
round those differently).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.models import gaussians as JG
from dimo_tpu.ops import neighbors as jnb
from dimo_tpu.presets import tiny_synthetic_opt as j_opt
from dimo_tpu.train.loop import Trainer as JTrainer

from dimo_tpu_torch.io.convert import params_from_numpy, port_leaves_from_numpy
from dimo_tpu_torch.models import gaussians as TG
from dimo_tpu_torch.ops import neighbors as tnb
from dimo_tpu_torch.presets import tiny_synthetic_opt as t_opt
from dimo_tpu_torch.train.loop import Trainer as TTrainer

from test_torch_math import jax_to_numpy
from test_torch_train_step import _leaves_numpy
from torch_parity import one_torch_thread  # noqa: F401

CAP = 64
PER_G = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
         "opacity")


def make_pair(seed=0, n_active=40, holes=(3, 11, 12, 30)):
    """The same state in both packages: (jp, ja, (jmu, jnu)), (tp, ta,
    (tmu, tnu))."""
    cfg = JG.ModelConfig(sh_degree=1, latent_dim=8, num_latents=2,
                         capacity=CAP, cpt_capacity=16, percent_dense=0.01)
    jp, ja = JG.init_model(cfg, seed=seed, num_pts=n_active, num_cpts=12)
    rng = np.random.RandomState(seed + 100)
    f32 = lambda a: jnp.asarray(a.astype(np.float32))  # noqa: E731
    active = np.asarray(ja.active).copy()
    active[list(holes)] = False
    jp = jp.replace(
        features_rest=f32(rng.randn(CAP, 3, 3) * 0.1),
        # log-scales around log(0.04): both sides of percent_dense * extent
        scaling=f32(np.log(0.04) + rng.randn(CAP, 3) * 0.6),
        rotation=f32(rng.randn(CAP, 4)),
        opacity=f32(rng.randn(CAP, 1) * 2.5 - 1.0),
        r=f32(np.full((1, 1), np.log(0.05))))
    ja = ja.replace(
        active=jnp.asarray(active),
        xyz_grad_accum=f32(rng.rand(CAP) * 0.08),
        denom=f32(rng.randint(0, 3, CAP)),
        max_radii2d=f32(rng.rand(CAP) * 9))
    jmom = tuple(jax.tree.map(lambda x: f32(rng.randn(*x.shape)), jp)
                 for _ in range(2))
    tp, ta = params_from_numpy(jax_to_numpy(jp, ja), device="cpu")
    tmom = tuple(port_leaves_from_numpy(_leaves_numpy(m), "cpu") for m in jmom)
    return (jp, ja, jmom), (tp, ta, tmom)


def assert_same(j, t, tol=0.0):
    """Per-Gaussian leaves, the bookkeeping and the moments of both sides."""
    (jp, ja, jmom), (tp, ta, tmom) = j, t
    for f in ("active", "c_active"):
        np.testing.assert_array_equal(getattr(ta, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    for f in ("max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_allclose(getattr(ta, f).numpy(),
                                   np.asarray(getattr(ja, f)), rtol=tol,
                                   atol=tol, err_msg=f)
    for f in PER_G:
        np.testing.assert_allclose(
            getattr(tp, f).detach().numpy(), np.asarray(getattr(jp, f)),
            rtol=tol, atol=tol, err_msg=f)
        for jm, tm in zip(jmom, tmom):
            np.testing.assert_array_equal(tm[f].numpy(),
                                          np.asarray(getattr(jm, f)), err_msg=f)


def jax_split_noise(key, n_split=2):
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.normal(k, (CAP, 3)))
        for k in jax.random.split(key, n_split)]))


def test_free_slot_of_rank_matches_jax():
    (_, ja, _), (_, ta, _) = make_pair()
    np.testing.assert_array_equal(TG._free_slot_of_rank(ta.active).numpy(),
                                  np.asarray(JG._free_slot_of_rank(ja.active)))


def test_densification_stats_and_max_radii_match_jax():
    (jp, ja, jm), (tp, ta, tm) = make_pair(1)
    rng = np.random.RandomState(5)
    g = rng.randn(CAP, 2).astype(np.float32)
    radii = (rng.rand(CAP) * 12).astype(np.float32)
    vis = rng.rand(CAP) > 0.4
    ja = JG.add_densification_stats(
        JG.update_max_radii(ja, jnp.asarray(radii), jnp.asarray(vis)),
        jnp.asarray(g), jnp.asarray(vis))
    ta = TG.add_densification_stats(
        TG.update_max_radii(ta, torch.from_numpy(radii), torch.from_numpy(vis)),
        torch.from_numpy(g), torch.from_numpy(vis))
    assert_same((jp, ja, jm), (tp, ta, tm), tol=1e-6)
    assert float(ta.denom.sum()) > float(np.asarray(make_pair(1)[0][1].denom).sum())


def test_clone_matches_jax():
    (jp, ja, jm), (tp, ta, tm) = make_pair(2)
    sel = np.asarray(ja.active) & (np.arange(CAP) % 3 == 0)
    j = JG._clone(jp, ja, jm, jnp.asarray(sel))
    t = TG._clone(tp, ta, tm, torch.from_numpy(sel))
    assert_same(j, t)
    assert int(TG.num_active(t[1])) == 40 - 4 + int(sel.sum())
    # a cloned row's moments are zero, its values the source's
    dest = int(TG._free_slot_of_rank(make_pair(2)[1][1].active)[0])
    assert float(t[2][0]["xyz"][dest].abs().sum()) == 0.0
    assert torch.equal(t[0].xyz[dest], t[0].xyz[int(np.nonzero(sel)[0][0])])


@pytest.mark.parametrize("stage", ["s1", "s2"])
def test_split_with_the_jax_noise_matches_jax(stage):
    (jp, ja, jm), (tp, ta, tm) = make_pair(3)
    sel = np.asarray(ja.active) & (np.arange(CAP) % 4 == 1)
    key = jax.random.PRNGKey(9)
    j = JG._split(jp, ja, jm, jnp.asarray(sel), key, stage)
    t = TG._split(tp, ta, tm, torch.from_numpy(sel), stage,
                  noise=jax_split_noise(key))
    assert_same(j, t, tol=1e-6)
    assert not bool(t[1].active[torch.from_numpy(sel)].any())   # originals go


def test_split_draws_from_its_generator():
    _, (tp, ta, tm) = make_pair(3)
    sel = ta.active & (torch.arange(CAP) % 4 == 1)
    with pytest.raises(ValueError, match="generator or noise"):
        TG._split(tp, ta, tm, sel, "s2")
    before = tp.xyz.detach().clone()
    _, aux, _ = TG._split(tp, ta, tm, sel, "s2",
                          generator=torch.Generator().manual_seed(0))
    new = aux.active & ~ta.active
    assert int(new.sum()) == 2 * int(sel.sum())
    assert not torch.equal(tp.xyz.detach()[new], before[new])


@pytest.mark.parametrize("stage,max_grad", [("s1", 0.01), ("s2", 0.01),
                                            ("s2", 0.03)])
def test_densify_and_prune_matches_jax(stage, max_grad):
    (jp, ja, jm), (tp, ta, tm) = make_pair(4)
    cfg_j = JG.ModelConfig(sh_degree=1, capacity=CAP, cpt_capacity=16)
    cfg_t = TG.ModelConfig(sh_degree=1, capacity=CAP, cpt_capacity=16)
    key = jax.random.PRNGKey(4)
    kw = dict(max_grad=max_grad, min_opacity=0.01, extent=4.0,
              max_screen_size=1.0)
    j = JG.densify_and_prune(cfg_j, jp, ja, jm, key, stage, **kw)
    t = TG.densify_and_prune(cfg_t, tp, ta, tm, stage,
                             noise=jax_split_noise(key), **kw)
    assert_same(j, t, tol=1e-6)
    n0, n1 = 36, int(TG.num_active(t[1]))
    assert n1 != n0                     # the case densified or pruned
    assert float(t[1].denom.sum()) == 0 and float(t[1].max_radii2d.sum()) == 0


def test_capacity_exhausted_drops_the_overflowing_rows():
    """More rows selected than free slots: the first ones (by index) land,
    the rest are dropped, in both packages."""
    (jp, ja, jm), (tp, ta, tm) = make_pair(5, n_active=62, holes=(7, 20, 41))
    sel = np.asarray(ja.active) & (np.arange(CAP) % 5 == 0)
    assert int(sel.sum()) > 5                   # 5 free slots: 2 + 3 holes
    j = JG._clone(jp, ja, jm, jnp.asarray(sel))
    t = TG._clone(tp, ta, tm, torch.from_numpy(sel))
    assert_same(j, t)
    assert int(TG.num_active(t[1])) == CAP
    (jp, ja, jm), (tp, ta, tm) = make_pair(5, n_active=62, holes=(7, 20, 41))
    key = jax.random.PRNGKey(1)
    j = JG._split(jp, ja, jm, jnp.asarray(sel), key, "s2")
    t = TG._split(tp, ta, tm, torch.from_numpy(sel), "s2",
                  noise=jax_split_noise(key))
    assert_same(j, t, tol=1e-6)


def test_prune_only_and_reset_opacity_match_jax():
    (jp, ja, jm), (tp, ta, tm) = make_pair(6)
    cfg_j = JG.ModelConfig(sh_degree=1, capacity=CAP, cpt_capacity=16)
    cfg_t = TG.ModelConfig(sh_degree=1, capacity=CAP, cpt_capacity=16)
    kw = dict(min_opacity=0.05, extent=4.0, max_screen_size=1.0)
    jp, ja = JG.prune_only(cfg_j, jp, ja, "s2", **kw)
    tp, ta = TG.prune_only(cfg_t, tp, ta, "s2", **kw)
    assert 0 < int(TG.num_active(ta)) < 36
    assert int(TG.num_active(ta)) == int(JG.num_active(ja))
    jp, jm = JG.reset_opacity(jp, jm)
    tp, tm = TG.reset_opacity(tp, tm)
    assert_same((jp, ja, jm), (tp, ta, tm), tol=1e-6)
    assert float(torch.sigmoid(tp.opacity).max()) <= 0.01 + 1e-6
    assert all(float(m["opacity"].abs().sum()) == 0 for m in tm)
    assert float(tm[0]["xyz"].abs().sum()) > 0


@pytest.mark.parametrize("num_pts", [12, 36, 50])
def test_fps_anneal_matches_jax(num_pts):
    """Indices and the kept set, also when more points are asked for than
    are active (the first valid index repeats)."""
    (jp, ja, jm), (tp, ta, tm) = make_pair(7)
    j_idx = np.asarray(jnb.farthest_point_sampling(jp.xyz, num_pts, ja.active))
    t_idx = tnb.farthest_point_sampling(tp.xyz.detach(), num_pts, ta.active)
    assert t_idx.dtype == torch.int32
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    jp, ja = JG.fps_anneal(jp, ja, num_pts)
    tp, ta = TG.fps_anneal(tp, ta, num_pts)
    assert_same((jp, ja, jm), (tp, ta, tm))
    assert int(TG.num_active(ta)) == min(num_pts, 36)


def test_initialize_ag_matches_jax():
    (jp, ja, _), (tp, ta, _) = make_pair(8)
    cfg_j = JG.ModelConfig(sh_degree=1, capacity=CAP, cpt_capacity=16)
    cfg_t = TG.ModelConfig(sh_degree=1, capacity=CAP, cpt_capacity=16)
    jp, ja = JG.initialize_ag(cfg_j, jp, ja, seed=3, num_pts_per_cpt=5,
                              init_ratio=1.0)
    tp, ta = TG.initialize_ag(cfg_t, tp, ta, seed=3, num_pts_per_cpt=5,
                              init_ratio=1.0)
    assert int(TG.num_active(ta)) == 12 * 5 == int(JG.num_active(ja))
    np.testing.assert_array_equal(ta.active.numpy(), np.asarray(ja.active))
    for f in ("xyz", "features_dc", "rotation", "opacity"):
        np.testing.assert_allclose(getattr(tp, f).detach().numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)
    # log of a 3-NN mean distance: matmul sums round differently
    np.testing.assert_allclose(tp.scaling.detach().numpy(),
                               np.asarray(jp.scaling), rtol=1e-4, atol=1e-4)


def test_grow_capacity_matches_jax():
    images = np.zeros((2, 3, 5, 8, 8, 3), np.uint8)
    masks = np.zeros((2, 3, 5, 8, 8), np.uint8)
    meta = {"azimuths": [0.0, 120.0, 240.0],
            "input_videos": ["motion_00", "motion_01"]}
    jt = JTrainer(j_opt(), images, masks, meta)
    tt = TTrainer(t_opt(), images, masks, meta, device="cpu")
    rng = np.random.RandomState(0)
    mu = jax.tree.map(lambda x: jnp.asarray(
        rng.randn(*x.shape).astype(np.float32)), jt.state.params)
    jt.state = jt.state.replace(opt=jt.state.opt.replace(mu=mu))
    tt.state.opt.mu = port_leaves_from_numpy(_leaves_numpy(mu), "cpu")
    jt._grow_capacity(128)
    tt._grow_capacity(128)
    assert tt.mcfg.capacity == 128 == jt.mcfg.capacity
    tp, jp = tt.state.params, jt.state.params
    for f in PER_G:
        leaf = getattr(tp, f)
        assert leaf.shape[0] == 128 and leaf.requires_grad, f
        # the two inits differ by an ulp in the log-scales; the padding is
        # exact
        np.testing.assert_allclose(leaf.detach().numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
        np.testing.assert_array_equal(leaf.detach().numpy()[64:],
                                      np.asarray(getattr(jp, f))[64:])
        np.testing.assert_array_equal(tt.state.opt.mu[f].numpy(),
                                      np.asarray(getattr(jt.state.opt.mu, f)))
        assert tt.state.opt.nu[f].shape == leaf.shape
    for f in ("active", "max_radii2d", "xyz_grad_accum", "denom"):
        np.testing.assert_array_equal(getattr(tt.state.aux, f).numpy(),
                                      np.asarray(getattr(jt.state.aux, f)))
    # the grown tensors are the ones the optimizer addresses
    from dimo_tpu_torch.train import optim as topt
    assert topt.named_leaves(tp)["xyz"] is tp.xyz
