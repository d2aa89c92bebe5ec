"""The port's CLIs (`dimo_tpu_torch/cli.py`, behind
`main_train_dimo_torch.py` and `main_test_dimo_torch.py`) against the JAX
package's (`main_train_dimo.py`, `main_test_dimo.py`), on the CPU.

Routing: each test-mode flag, alone and in every pair, through both
CLIs, with the routed `test_modes` functions (and `Trainer.train_dynamic`
for the train CLI) replaced in both packages by recorders; the recorded
function names and arguments must be identical: trainers by their
motions and sizes, arrays by dtype, shape and bytes, callables by being
callable. LPIPS is replaced by a recorder of its path and fallback there
(the train run below builds it for real). The data: a PNG folder of 2
motions x 2 views x 3 frames at 16x16 written here, and a (1, 768)
embedding in a .npy.

Training: `train_main([...], device="cpu")` on `input_folder=synthetic`
at `tiny_synthetic_opt`'s sizes (3 s1 + 2 s2 iterations, LPIPS's seeded
fallback), then the JAX package's `Trainer` loads its s2 checkpoint: its
Gaussians, control points, latents and TimeNet must equal the port's
final state (no tolerance: the checkpoint files carry float32 as is).
"""
import hashlib
import itertools
import os
import sys

import numpy as np
import pytest

import main_test_dimo
import main_train_dimo
from dimo_tpu import test_modes as jtm
from dimo_tpu.io.config import load_config as j_load_config
from dimo_tpu.models import lpips as jlpips
from dimo_tpu.train import loop as jloop

from dimo_tpu_torch import cli
from dimo_tpu_torch import test_modes as ttm
from dimo_tpu_torch.io.convert import timenet_to_numpy
from dimo_tpu_torch.models import lpips as tlpips
from dimo_tpu_torch.train import loop as tloop

from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST_CONFIG = os.path.join(REPO, "configs", "test_config.yaml")
TRAIN_CONFIG = os.path.join(REPO, "configs", "train_config.yaml")
MODES = ("test_fps", "test_motion", "test_unaligned_motion", "test_language",
         "test_interpolation", "test_paper")
ROUTED = ("run_test_fps", "run_test_motion", "run_test_unaligned_motion",
          "run_test_language", "run_test_interpolation", "run_test_paper",
          "run_default_test")
CASES = [()] + [(m,) for m in MODES] + list(itertools.combinations(MODES, 2))
TINY = ["ref_size=16", "num_views=2", "num_frames=3", "num_cpts=8",
        "capacity_s1=64", "tile_capacity=64", "latent_code_dim=8", "W=32",
        "H=32"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A PNG folder of two RGBA motions, and a (1, 768) embedding."""
    import cv2
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    folder = root / "videos"
    for name in ("jump", "wave"):
        for v in range(2):
            d = folder / name / f"view_{v:02d}"
            d.mkdir(parents=True)
            for f in range(3):
                cv2.imwrite(str(d / f"{f:02d}.png"),
                            rng.randint(0, 256, (20, 20, 4)).astype(np.uint8))
    emb = root / "emb.npy"
    np.save(emb, rng.randn(1, 768).astype(np.float32))
    return {"folder": str(folder), "emb": str(emb), "root": root}


def _norm(x):
    if isinstance(x, (jloop.Trainer, tloop.Trainer)):
        return ("trainer", tuple(x.input_videos), x.num_views, x.num_frames,
                x.images.shape, hashlib.sha1(x.images.tobytes()).hexdigest(),
                hashlib.sha1(x.masks.tobytes()).hexdigest(),
                str(x.opt.save_path))
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if callable(x):
        return "callable"
    return x


@pytest.fixture
def recorded(monkeypatch):
    """{package: [(name, args, kwargs)]} of the routed calls."""
    rec = {"jax": [], "torch": []}

    def recorder(which, name):
        def fn(*a, **k):
            rec[which].append((name, [_norm(x) for x in a],
                               {key: _norm(v) for key, v in k.items()}))
        return fn

    for which, mod in (("jax", jtm), ("torch", ttm)):
        for name in ROUTED:
            monkeypatch.setattr(mod, name, recorder(which, name))
    for which, cls in (("jax", jloop.Trainer), ("torch", tloop.Trainer)):
        monkeypatch.setattr(cls, "train_dynamic",
                            recorder(which, "train_dynamic"))
    monkeypatch.setattr(jlpips, "get_lpips",
                        lambda path, fallback="random", **k: ("lpips", path,
                                                              fallback))
    monkeypatch.setattr(tlpips, "get_lpips",
                        lambda path, fallback="random", **k: ("lpips", path,
                                                              fallback))
    return rec


def _run_both(monkeypatch, jax_main, config, dots, port_main):
    monkeypatch.setattr(sys, "argv", ["main.py", "--config", config, *dots])
    jax_main()
    port_main(["--config", config, *dots], device="cpu")


@pytest.mark.parametrize("flags", CASES,
                         ids=["default"] + ["+".join(c) for c in CASES[1:]])
def test_test_cli_routes_like_jax(data, tmp_path, monkeypatch, recorded,
                                  flags):
    dots = TINY + [f"input_folder={data['folder']}",
                   f"save_path={tmp_path / 'run'}",
                   f"video_save_dir={tmp_path / 'videos'}",
                   f"test_motion_data={data['folder']}",
                   f"test_unaligned_motion_data={data['folder']}",
                   f"test_text_emb={data['emb']}", "test_text_prompt=hi",
                   "render_type=circle", "test_step=7"]
    dots += [f"{f}=True" for f in flags]
    _run_both(monkeypatch, main_test_dimo.main, TEST_CONFIG, dots,
              cli.test_main)
    assert recorded["torch"] == recorded["jax"]
    assert len(recorded["jax"]) == 1
    first = next((m for m in MODES if m in flags), None)
    want = "run_default_test" if first is None else f"run_{first}"
    assert recorded["jax"][0][0] == want


@pytest.mark.parametrize("case", ["dynamic", "static", "save_path_new"])
def test_train_cli_routes_like_jax(data, tmp_path, monkeypatch, recorded,
                                   case):
    dots = TINY + [f"input_folder={data['folder']}",
                   f"save_path={tmp_path / 'run'}",
                   f"video_save_dir={tmp_path / 'videos'}",
                   "iters_s1=4", "iters_s2=2", "snapshot_every=3",
                   "render_type=fixed",
                   f"train_dynamic={case == 'dynamic'}"]
    if case == "save_path_new":
        dots.append(f"save_path_new={tmp_path / 'new'}")
    _run_both(monkeypatch, main_train_dimo.main, TRAIN_CONFIG, dots,
              cli.train_main)
    assert recorded["torch"] == recorded["jax"]
    name, args, kwargs = recorded["jax"][0]
    if case == "dynamic":
        assert name == "train_dynamic" and args[1:3] == [4, 2]   # self, ...
        assert args[0][1] == ("jump", "wave") and args[0][4][3] == 16
        assert kwargs["snapshot_every"] == 3
        assert os.path.exists(tmp_path / "run" / "config.yaml")
    else:
        assert name == "run_default_test"
        want = "new" if case == "save_path_new" else "run"
        assert args[0][-1] == str(tmp_path / want)


def test_train_cli_synthetic_checkpoint_loads_in_jax(tmp_path):
    save = str(tmp_path / "run")
    dots = ["train_dynamic=True", "input_folder=synthetic", f"save_path={save}",
            "ref_size=64", "num_views=3", "num_frames=5", "num_cpts=24",
            "capacity_s1=64", "tile_capacity=64", "iters_s1=3", "iters_s2=2",
            "batch_size=1", "num_pts_per_cpt=4", "latent_code_dim=8",
            "save_inter=100000", "W=128", "H=128"]
    tt = cli.train_main(["--config", TRAIN_CONFIG, *dots], device="cpu")
    assert tt.stage == "s2" and tt.device.type == "cpu"
    with open(os.path.join(save, "config.yaml")) as f:
        assert "input_folder: synthetic" in f.read()
    for stage in ("s1", "s2"):
        assert os.path.exists(os.path.join(save, stage, "point_cloud.ply"))

    opt = j_load_config(TRAIN_CONFIG, dots)
    meta = {"input_videos": list(tt.input_videos), "azimuths": tt.azimuths}
    jt = jloop.Trainer(opt, tt.images, tt.masks, meta)
    jt.load_checkpoint("s2")
    p, a = tt.state.params, tt.state.aux
    jp, ja = jt.state.params, jt.state.aux
    act, c_act = a.active.numpy(), a.c_active.numpy()
    n, k = int(act.sum()), int(c_act.sum())
    assert n == int(np.asarray(ja.active).sum()) and n > 0
    assert k == int(np.asarray(ja.c_active).sum()) and k > 0
    for f in ("xyz", "features_dc", "scaling", "rotation", "opacity"):
        assert np.array_equal(np.asarray(getattr(jp, f))[:n],
                              getattr(p, f).detach().numpy()[act]), f
    assert np.array_equal(np.asarray(jp.c_xyz)[:k],
                          p.c_xyz.detach().numpy()[c_act])
    assert np.array_equal(np.asarray(jp.latent["codes"]),
                          p.latent["codes"].detach().numpy())
    t_net = timenet_to_numpy(p.timenet)
    for key, v in jp.timenet.items():
        assert np.array_equal(np.asarray(v), t_net[key]), key


def test_cli_shims_call_the_package():
    """The root scripts are the package's entry points, run only as
    `__main__`."""
    for name, fn in (("main_train_dimo_torch.py", "train_main"),
                     ("main_test_dimo_torch.py", "test_main")):
        src = open(os.path.join(REPO, name)).read()
        assert f"from dimo_tpu_torch.cli import {fn}" in src
        assert 'if __name__ == "__main__":' in src
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.test_main(["--config", TEST_CONFIG])
