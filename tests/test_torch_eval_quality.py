"""The port's quality run (`dimo_tpu_torch/eval_quality.py`) against
`scripts/eval_quality.py`, on the CPU: the configuration it trains with,
and the test-set PSNR scoring on one tiny checkpoint that both packages'
trainers load (`tests/test_torch_test_modes.py`'s: 2 motions x 3 views x 5
frames of 64x64 synthetic video, TimeNet's output layers seeded so the
control points move).

Tolerances: the configuration equal, key for key, apart from the two
output directories (the port writes under its checkout's `build/`); the
per-image MSE 1e-4 relative and the PSNR 1e-4 dB (the renders agree to
the rasterizer's 1e-4 with a rare alpha-cut flip, `test_torch_render.py`).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from dimo_tpu_torch import eval_quality as teq
from dimo_tpu_torch.io.synthetic import make_synthetic_videos
from dimo_tpu_torch.presets import tiny_synthetic_opt as t_opt
from dimo_tpu_torch.train.loop import Trainer as TTrainer

from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("save_path", "video_save_dir")


def reference_module():
    spec = importlib.util.spec_from_file_location(
        "reference_eval_quality", os.path.join(REPO, "scripts",
                                               "eval_quality.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kw", [{}, {"fast": True}, {"scale512": True},
                                {"iters": "1400,5000"},
                                {"fast": True, "iters": "30,20"}],
                         ids=["default", "fast", "scale512", "iters",
                              "fast-iters"])
def test_build_config_is_the_reference_one(kw):
    ref = reference_module()
    *j_shape, j_opt = ref.build_config(**kw)
    *t_shape, t_opt_ = teq.build_config(**kw)
    assert t_shape == j_shape
    assert {k: v for k, v in t_opt_.items() if k not in PATHS} == \
        {k: v for k, v in j_opt.items() if k not in PATHS}
    assert t_opt_.tile_capacity_max == 2048
    assert teq.PSNR_GATE == ref.PSNR_GATE == 26.0
    assert t_opt_.save_path.startswith(os.path.join(REPO, "build"))


def test_arguments_are_the_reference_ones():
    args = teq.parse_args(["--fast", "--no-lpips", "--iters", "30,20",
                           "--load-stage", "s1", "--snapshot-every", "7"])
    assert (args.fast, args.no_lpips, args.iters, args.load_stage,
            args.snapshot_every, args.scale512) == \
        (True, True, "30,20", "s1", 7, False)
    assert teq.parse_args([]).snapshot_every == 500


def _move_timenet(tr, seed):
    rng = np.random.RandomState(seed)
    net = tr.state.params.timenet
    with torch.no_grad():
        for lin in (net.pts_1, net.rot_1):
            lin.weight.copy_(torch.from_numpy(
                (0.02 * rng.randn(*lin.weight.shape)).astype(np.float32)))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    data = make_synthetic_videos(num_motions=2, num_views=3, num_frames=5,
                                 ref_size=64, n_gauss=40, seed=0, device="cpu")
    save = str(tmp_path_factory.mktemp("ckpt") / "run")
    tr = TTrainer(t_opt(save_path=save), *data, device="cpu")
    tr.prepare_train_s1()
    _move_timenet(tr, 1)
    tr.finish_s1()
    tr.prepare_train_s2()
    _move_timenet(tr, 2)
    tr.finish_s2()
    return data, save


def test_score_psnr_is_the_reference_scoring(ckpt):
    """`score_psnr` against the reference's scoring loop
    (`scripts/eval_quality.py`: KNN once, every (motion, view, frame) at
    the trainer's capacity, white background)."""
    import jax
    import jax.numpy as jnp
    from dimo_tpu.models.renderer import find_knn, render
    from dimo_tpu.presets import tiny_synthetic_opt as j_opt
    from dimo_tpu.train.loop import Trainer as JTrainer

    data, save = ckpt
    images = data[0]
    M, V, F, S = images.shape[:4]
    cap = 64
    jt = JTrainer(j_opt(save_path=save), *data)
    jt.load_checkpoint("s2")
    knn = jax.jit(find_knn)(jt.state.params, jt.state.aux)

    @jax.jit
    def one(cam, t, li):
        return render(jt.mcfg, jt.state.params, jt.state.aux, cam, t, "s2",
                      li, S, S, jnp.ones((3,)), knn_cache=knn,
                      capacity=cap)["image"]

    j_mses = []
    for m in range(M):
        for v in range(V):
            for f in range(F):
                img = one(jt.camera_for(jt.azimuths[v]), f / F, m)
                gt = jnp.asarray(images[m, v, f],
                                 jnp.float32).transpose(2, 0, 1) / 255.0
                j_mses.append(float(jnp.mean((img - gt) ** 2)))
    j_psnr = float(10 * np.log10(1.0 / np.mean(j_mses)))

    tt = TTrainer(t_opt(save_path=save), *data, device="cpu")
    tt.load_checkpoint("s2")
    psnr, mses = teq.score_psnr(tt, images, cap)
    assert len(mses) == M * V * F
    print("score_psnr", psnr, "reference", j_psnr, "per-image MSE max rel",
          float(np.max(np.abs(np.subtract(mses, j_mses)) / np.array(j_mses))))
    np.testing.assert_allclose(mses, j_mses, rtol=1e-4)
    assert abs(psnr - j_psnr) <= 1e-4
    assert len(set(np.round(mses, 6))) > 1          # frames differ


def test_quality_run_writes_the_reference_keys(tmp_path, capsys,
                                               monkeypatch):
    """`main` end to end on the CPU with the configuration cut to a smoke
    size (2 motions x 2 views x 3 frames at 32^2, 24 control points, 2 + 1
    iterations): the reference's JSON keys plus `videos_error`, a finite
    PSNR, the live capacity, the video step's outcome."""
    full = teq.build_config

    def small(**kw):
        *_, iters_s1, iters_s2, opt = full(**kw)
        opt.update(ref_size=32, W=64, H=64, num_views=2, num_frames=3,
                   num_cpts=24, num_pts=64, num_pts_per_cpt=4,
                   capacity_s1=64, tile_capacity=64, latent_code_dim=8)
        return 2, 2, 3, 32, iters_s1, iters_s2, opt

    monkeypatch.setattr(teq, "build_config", small)
    out = tmp_path / "q.json"
    res = teq.main(["--fast", "--iters", "2,1", "--no-lpips",
                    "--out", str(out), "--run-dir", str(tmp_path / "run"),
                    "--videos", str(tmp_path / "videos"),
                    "--snapshot-every", "0"], device="cpu")
    assert json.loads(out.read_text()) == res
    with open(os.path.join(REPO, "eval_quality_r5.json")) as f:
        want = set(json.load(f))
    assert set(res) == want | {"videos_error"}
    assert np.isfinite(res["psnr"]) and res["passed"] is None
    assert res["iters"] == [2, 1] and res["resolution"] == 32
    assert res["eval_capacity"] == 64 and res["lpips"] is False
    assert res["videos_ok"] is True and res["videos_error"] is None
    assert "[eval_quality] test PSNR over 12 renders" in \
        capsys.readouterr().out
