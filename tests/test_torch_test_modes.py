"""The port's serving test modes (`dimo_tpu_torch/test_modes.py`) against
the JAX package's, on the CPU.

One checkpoint serves the module: the port's `Trainer` at
`tiny_synthetic_opt`'s size (2 motions x 3 views x 5 frames of 64x64
synthetic video, 24 control points, 4 Gaussians each in stage 2, 128x128
renders, capacity 64) writes its s1 and s2 checkpoints, with TimeNet's
zero-initialised output layers set from a numpy seed so that the control
points move; both packages' trainers load them. The JAX side runs its
Pallas kernels in interpret mode, as `tests/test_test_modes.py` does; the
port runs its kernels' plain versions. Video writers are replaced by
recorders in both packages, so the frames every writer was given are
compared.

Tolerances:
  * rendered frames (uint8): within 1 LSB plus 1e-4 (the strip
    compositor's ch7 tolerance, `test_torch_render.py`), except on the few
    pixels where an entry's alpha sits on the 1/255 cut
    (`assert_close_except_cut_flips`);
  * control-point trajectories in pixels (`traj_pts`): 1e-3 px. The
    trajectory images are drawn by `cv2.polylines` from int32-truncated
    points, so a 1e-5 px difference can move one of their pixels: they
    are compared by shape here, and bit for bit from identical points in
    `test_torch_viz.py`;
  * `cpt_model`'s fields, the interpolated latents, the file names, the
    mosaics and the blends: equal.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from dimo_tpu import test_modes as jtm
from dimo_tpu import viz as jviz
from dimo_tpu.presets import tiny_synthetic_opt as j_opt
from dimo_tpu.train.loop import Trainer as JTrainer

from dimo_tpu_torch import test_modes as ttm
from dimo_tpu_torch import viz as tviz
from dimo_tpu_torch.io.synthetic import make_synthetic_videos
from dimo_tpu_torch.presets import tiny_synthetic_opt as t_opt
from dimo_tpu_torch.train.loop import Trainer as TTrainer

from torch_parity import assert_close_except_cut_flips
from torch_parity import one_torch_thread  # noqa: F401

FRAME_TOL = 1.0 / 255.0 + 1e-4
TRAJ_TOL = 1e-3


def _move_timenet(tr, seed):
    """Give TimeNet's zero-initialised output layers seeded weights, so the
    control points move over time and between motions."""
    rng = np.random.RandomState(seed)
    net = tr.state.params.timenet
    with torch.no_grad():
        for lin, scale in ((net.pts_1, 0.02), (net.rot_1, 0.02)):
            lin.weight.copy_(torch.from_numpy(
                (scale * rng.randn(*lin.weight.shape)).astype(np.float32)))


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


def trainers(ckpt, tmp_path, **kw):
    """A JAX and a port trainer on the checkpoint, each writing into its
    own video folder."""
    data, save = ckpt
    jt = JTrainer(j_opt(save_path=save, video_save_dir=str(tmp_path / "jax"),
                        **kw), *data)
    tt = TTrainer(t_opt(save_path=save, video_save_dir=str(tmp_path / "torch"),
                        **kw), *data, device="cpu")
    return jt, tt


@pytest.fixture
def written(monkeypatch):
    """{package: {file name: frames (F, H, W, C) uint8}} of every video
    written, with the writers replaced by recorders in both packages."""
    rec = {"jax": {}, "torch": {}}

    def recorder(which):
        def write_video(path, frames, fps=8):
            rec[which][os.path.basename(path)] = np.stack(
                [np.asarray(f) for f in frames])
        return write_video

    monkeypatch.setattr(jviz, "write_video", recorder("jax"))
    monkeypatch.setattr(tviz, "write_video", recorder("torch"))
    return rec


def assert_frames_close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape, what
    for i, (g, r) in enumerate(zip(got, ref)):
        assert_close_except_cut_flips(
            g.transpose(2, 0, 1) / 255.0, r.transpose(2, 0, 1) / 255.0,
            FRAME_TOL, f"{what} frame {i}")


def test_default_test_matches_jax(ckpt, tmp_path, written):
    jt, tt = trainers(ckpt, tmp_path)
    j_imgs = jtm.run_default_test(jt, render_type="fixed", do_cpts=True)
    t_imgs = ttm.run_default_test(tt, render_type="fixed", do_cpts=True)
    assert len(t_imgs) == len(j_imgs) == 2
    for m, (g, r) in enumerate(zip(t_imgs, j_imgs)):
        assert g.shape == (5, 128, 128, 3)
        assert_frames_close(g, r, f"motion {m}")
        assert g[0].std() > 1.0
    assert not np.array_equal(t_imgs[0], t_imgs[1])
    names = sorted(written["torch"])
    assert names == sorted(written["jax"])
    assert {"all_render_imgs.mp4", "all_traj_imgs.mp4",
            "all_traj_imgs_3d.mp4", "run_motion_00_s2_fixed.mp4",
            "run_motion_01_cpts_0.mp4",
            "trajectory_3d_motion_00.mp4"} <= set(names)
    for name in names:
        g, r = written["torch"][name], written["jax"][name]
        assert g.shape == r.shape, name
        if "cpts" in name or "s2_fixed" in name or name == "all_render_imgs.mp4":
            assert_frames_close(g, r, name)
    # the PNG and HTML files beside the videos
    assert sorted(os.listdir(tmp_path / "torch")) == \
        sorted(os.listdir(tmp_path / "jax"))


@pytest.fixture(scope="module")
def jax_render_fn(ckpt, tmp_path_factory):
    """One jitted JAX render for every sequence of the module (the model
    and camera are arguments, so one compile serves both render types)."""
    jt, _ = trainers(ckpt, tmp_path_factory.mktemp("render_fn"))
    jt.load_checkpoint("s2")
    return jtm._jit_render(jt, "s2", 128, 128)


@pytest.mark.parametrize("render_type", ["fixed", "circle"])
def test_render_sequence_matches_jax(ckpt, tmp_path, jax_render_fn,
                                     render_type):
    jt, tt = trainers(ckpt, tmp_path)
    jt.load_checkpoint("s2")
    tt.load_checkpoint("s2")
    ref = jtm.render_sequence(jt, 1, "s2", render_type,
                              render_fn=jax_render_fn)
    got = ttm.render_sequence(tt, 1, "s2", render_type)
    assert len(got) == len(ref) == 5
    assert_frames_close(np.stack(got), np.stack(ref), render_type)


def _cpt_fields(params, aux):
    def np_(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    out = {k: np_(getattr(params, k)) for k in
           ("xyz", "scaling", "rotation", "opacity", "r")}
    out.update(active=np_(aux.active), c_active=np_(aux.c_active))
    return out


@pytest.mark.parametrize("stage", ["s2", "s1"])
def test_cpt_model_and_test_cpts_match_jax(ckpt, tmp_path, written, stage):
    """s2: the control points (`c_xyz`); s1 with `c_active` cleared: the
    Gaussians themselves (`cpt_model`'s other branch)."""
    jt, tt = trainers(ckpt, tmp_path)
    jt.load_checkpoint(stage)
    tt.load_checkpoint(stage)
    if stage == "s1":
        jt.state = jt.state.replace(aux=jt.state.aux.replace(
            c_active=jnp.zeros_like(jt.state.aux.c_active)))
        tt.state.aux = tt.state.aux.replace(
            c_active=torch.zeros_like(tt.state.aux.c_active))
    jc, jp, ja, _ = jtm.cpt_model(jt)
    tc, tp, ta, _ = ttm.cpt_model(tt)
    assert (tc.capacity, tc.cpt_capacity, tc.latent_dim, tc.vae) == \
        (jc.capacity, jc.cpt_capacity, jc.latent_dim, jc.vae)
    got, ref = _cpt_fields(tp, ta), _cpt_fields(jp, ja)
    for k, v in ref.items():
        assert np.array_equal(got[k], v), k
    base = tt.state.params.c_xyz if stage == "s2" else tt.state.params.xyz
    assert torch.equal(tp.xyz, base)
    assert tp.latent is tt.state.params.latent
    assert tp.timenet is tt.state.params.timenet

    make_3d = stage == "s2"
    j_out = jtm.test_cpts(jt, test_stage=stage, latent_index=1,
                          motion_video_name="m1", make_3d=make_3d)
    t_out = ttm.test_cpts(tt, test_stage=stage, latent_index=1,
                          motion_video_name="m1", make_3d=make_3d)
    assert_frames_close(np.stack(t_out[0]), np.stack(j_out[0]), "cpt frames")
    n_act = int(ta.active.sum())
    assert t_out[3].shape == j_out[3].shape == (n_act, 5, 2)
    np.testing.assert_allclose(t_out[3], j_out[3], rtol=0, atol=TRAJ_TOL)
    assert float(np.ptp(t_out[3], axis=1).max()) > 0.5     # the points move
    assert len(t_out[1]) == len(j_out[1]) == 5
    assert [x.shape for x in t_out[1]] == [x.shape for x in j_out[1]]
    assert [x.shape for x in t_out[2]] == [x.shape for x in j_out[2]]
    assert sorted(written["torch"]) == sorted(written["jax"])
    assert sorted(os.listdir(tmp_path / "torch")) == \
        sorted(os.listdir(tmp_path / "jax"))


def test_interpolation_matches_jax(ckpt, tmp_path, written):
    jt, tt = trainers(ckpt, tmp_path)
    ref = jtm.run_test_interpolation(jt)
    got = ttm.run_test_interpolation(tt)
    j_codes = np.asarray(jt.state.params.latent["codes"])
    t_codes = tt.state.params.latent["codes"].numpy()
    assert t_codes.shape == j_codes.shape == (2, 8)
    assert np.array_equal(t_codes, j_codes)
    assert np.array_equal(t_codes[0], t_codes[1])
    assert_frames_close(np.stack(got), np.stack(ref), "interpolation")
    assert sorted(written["torch"]) == sorted(written["jax"])
    assert "intp_motion_00_motion_01_blend.mp4" in written["torch"]


def test_paper_file_names_and_blends_match_jax(ckpt, tmp_path, written,
                                               monkeypatch):
    """`run_test_paper`'s routing, names and blends, with its renders
    replaced in both packages by the same seeded frames (the renders are
    held above)."""
    rng = np.random.RandomState(5)
    frames = [rng.randint(0, 256, (128, 128, 3)).astype(np.uint8)
              for _ in range(5)]
    trajs = [(rng.rand(128, 128, 3) > 0.9).astype(np.uint8) * 200
             for _ in range(5)]
    calls = {"jax": [], "torch": []}

    def fakes(which):
        def test_cpts(tr, test_stage="s2", render_type="fixed",
                      latent_index=0, motion_video_name="motion",
                      make_3d=True):
            calls[which].append(("cpts", latent_index, motion_video_name))
            return frames, trajs, [], None

        def render_sequence(tr, latent_index, stage, render_type="fixed",
                            render_fn=None):
            calls[which].append(("seq", latent_index, stage, render_type))
            return frames
        return test_cpts, render_sequence

    for which, mod in (("jax", jtm), ("torch", ttm)):
        cpts, seq = fakes(which)
        monkeypatch.setattr(mod, "test_cpts", cpts)
        monkeypatch.setattr(mod, "render_sequence", seq)
    jt, tt = trainers(ckpt, tmp_path)
    for motions in (None, ["motion_01"]):
        jtm.run_test_paper(jt, motions)
        ttm.run_test_paper(tt, motions)
    assert calls["torch"] == calls["jax"] and len(calls["jax"]) == 9
    assert sorted(written["torch"]) == sorted(written["jax"])
    assert "paper_motion_01_orbit.mp4" in written["torch"]
    for name, ref in written["jax"].items():
        assert np.array_equal(written["torch"][name], ref), name


def test_fps_harness(ckpt, tmp_path):
    _, tt = trainers(ckpt, tmp_path)
    fps = ttm.run_test_fps(tt, rounds=3, size=128)
    assert fps > 0
    tt.opt["spatial_parallel"] = 2      # outside a group of two ranks
    with pytest.raises(ValueError, match="spatial_parallel=2 needs one process"):
        ttm.run_test_fps(tt, rounds=3, size=128)


@pytest.mark.parametrize("n_clips", [0, 1, 2, 3, 4, 5])
def test_write_mosaic_matches_jax(written, tmp_path, n_clips):
    rng = np.random.RandomState(n_clips)
    clips = [rng.randint(0, 256, (3, 16, 24, 4)).astype(np.uint8)
             for _ in range(n_clips)]
    jtm._write_mosaic(str(tmp_path), "grid.mp4", clips)
    ttm._write_mosaic(str(tmp_path), "grid.mp4", clips)
    assert written["torch"].keys() == written["jax"].keys()
    for name, ref in written["jax"].items():
        assert np.array_equal(written["torch"][name], ref)
        assert ref.shape[-1] == 3


def test_default_test_without_matplotlib_or_imageio(ckpt, tmp_path,
                                                    monkeypatch):
    """The card's machine has neither library: the default mode runs
    through the real writers (OpenCV's mp4), and the 3-D track video is
    drawn by `viz._plot_3d_tracks_raster`, once for each motion."""
    for name in [m for m in sys.modules if m.split(".")[0] in
                 ("matplotlib", "mpl_toolkits", "imageio")]:
        monkeypatch.delitem(sys.modules, name)
    for name in ("matplotlib", "mpl_toolkits", "imageio"):
        monkeypatch.setitem(sys.modules, name, None)
    raster, drawn = tviz._plot_3d_tracks_raster, []

    def spy(tracks, *a):
        drawn.append(tracks.shape)
        return raster(tracks, *a)
    monkeypatch.setattr(tviz, "_plot_3d_tracks_raster", spy)
    _, tt = trainers(ckpt, tmp_path)
    imgs = ttm.run_default_test(tt, render_type="fixed", do_cpts=True)
    assert len(imgs) == 2 and len(drawn) == 2
    import cv2
    out = tmp_path / "torch"
    for motion in ("motion_00", "motion_01"):
        assert (out / f"trajectory_3d_{motion}.html").stat().st_size > 0
        cap = cv2.VideoCapture(str(out / f"trajectory_3d_{motion}.mp4"))
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        cap.release()
        assert len(frames) == 5 and frames[0].shape == (500, 500, 3)
        for i, f in enumerate(frames):
            assert (f < 250).any(-1).sum() > 100, f"{motion} frame {i}: no ink"
    assert {"all_traj_imgs_3d.mp4", "all_render_imgs.mp4",
            "run_motion_00_s2_fixed.mp4"} <= set(os.listdir(out))
    assert not [n for n in os.listdir(out) if n.endswith(".gif")]
