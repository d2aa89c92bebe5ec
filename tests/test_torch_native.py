"""The port's native runtime bindings (`dimo_tpu_torch/io/native.py`):
`tests/test_native.py`'s cases on the port, the PLY files of each package
read by the other, the trainer's host-path batches against `dimo_tpu`'s,
and the packer's slot hold. Arrays compare equal
(uint8 frames, float32 columns): nothing here rounds.
"""
import numpy as np
import pytest
import torch

from dimo_tpu.io import native as j_native
from dimo_tpu.io import ply as j_ply

from dimo_tpu_torch.io import native, ply
from dimo_tpu_torch.io.synthetic import make_synthetic_videos
from dimo_tpu_torch.presets import tiny_synthetic_opt as t_opt
from dimo_tpu_torch.train.loop import Trainer as TTrainer

from torch_parity import one_torch_thread  # noqa: F401


def test_library_loads():
    assert native.available()
    assert native.library_path() == native.REPO_LIB


def test_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    cols = rng.randn(100, 5).astype(np.float32)
    names = ["x", "y", "z", "opacity", "scale_0"]
    path = str(tmp_path / "n.ply")
    assert native.ply_write(path, names, cols)
    out = native.ply_read(path)
    assert list(out.keys()) == names
    for i, n in enumerate(names):
        np.testing.assert_array_equal(out[n], cols[:, i])


def _cloud(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3).astype(np.float32),
            rng.randn(n, 1, 3).astype(np.float32),
            rng.randn(n, 3, 3).astype(np.float32),
            rng.randn(n, 1).astype(np.float32),
            rng.randn(n, 3).astype(np.float32),
            rng.randn(n, 4).astype(np.float32))


def test_python_reads_native_file(tmp_path, monkeypatch):
    """The numpy codec parses the files the C++ writes."""
    path = str(tmp_path / "pc.ply")
    ply.save_gaussians(path, *_cloud(17, 1))
    out_native = ply._read_ply(path)
    monkeypatch.setattr(native, "_LIB", None)
    out_py = ply._read_ply(path)
    assert out_py.keys() == out_native.keys()
    for k in out_py:
        np.testing.assert_array_equal(out_native[k], out_py[k])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_ply_files_read_by_the_other_package(tmp_path, writer):
    """A Gaussian cloud and a control-point cloud written by one package
    (its native codec) read back by the other, both routes, equal."""
    xyz, fdc, frest, op, sc, rot = _cloud(33, 2)
    c_xyz, c_rad = xyz[:9], op[:9]
    g_path, c_path = str(tmp_path / "g.ply"), str(tmp_path / "c.ply")
    w, r = (j_ply, ply) if writer == "jax" else (ply, j_ply)
    w.save_gaussians(g_path, xyz, fdc, frest, op, sc, rot)
    w.save_control_points(c_path, c_xyz, c_rad)
    g = r.load_gaussians(g_path, sh_degree=1)
    for got, want in ((g["xyz"], xyz), (g["features_dc"], fdc),
                      (g["features_rest"], frest), (g["opacity"], op),
                      (g["scaling"], sc), (g["rotation"], rot)):
        np.testing.assert_array_equal(got, want)
    c = r.load_control_points(c_path)
    np.testing.assert_array_equal(c["c_xyz"], c_xyz)
    np.testing.assert_array_equal(c["c_radius"], c_rad)
    with open(g_path, "rb") as f:
        raw = f.read()
    other = str(tmp_path / "other.ply")
    r.save_gaussians(other, xyz, fdc, frest, op, sc, rot)
    with open(other, "rb") as f:
        assert f.read() == raw                 # byte for byte the same file


def test_packer_gathers_correct_frames():
    rng = np.random.RandomState(2)
    images = rng.randint(0, 255, (20, 8, 8, 3), dtype=np.uint8)
    masks = rng.randint(0, 255, (20, 8, 8), dtype=np.uint8)
    p = native.BatchPacker(images, masks, batch=4)
    idx = np.array([3, 17, 0, 9], np.int64)
    p.submit(idx)
    img, msk = p.get()
    assert isinstance(img, torch.Tensor) and img.dtype == torch.uint8
    np.testing.assert_array_equal(img.numpy(), images[idx])
    np.testing.assert_array_equal(msk.numpy(), masks[idx])
    idx2 = np.array([1, 2, 3, 4], np.int64)
    p.submit(idx2)
    img, msk = p.get()
    np.testing.assert_array_equal(img.numpy(), images[idx2])
    p.close()


def test_double_buffered_prefetch():
    """submit(k+1) before get(k)'s buffers are consumed: slots must not
    alias (the Trainer's pipelined use)."""
    rng = np.random.RandomState(3)
    images = rng.randint(0, 255, (30, 4, 4, 3), dtype=np.uint8)
    masks = rng.randint(0, 255, (30, 4, 4), dtype=np.uint8)
    p = native.BatchPacker(images, masks, batch=3, slots=2)
    a = np.array([5, 6, 7], np.int64)
    b = np.array([20, 1, 2], np.int64)
    c = np.array([9, 9, 0], np.int64)
    p.submit(a)
    img_a, msk_a = p.get()
    p.submit(b)                      # packs into the OTHER slot
    np.testing.assert_array_equal(img_a.numpy(), images[a])   # slot a intact
    img_b, _ = p.get()
    p.submit(c)
    np.testing.assert_array_equal(img_b.numpy(), images[b])
    img_c, msk_c = p.get()
    np.testing.assert_array_equal(img_c.numpy(), images[c])
    np.testing.assert_array_equal(msk_c.numpy(), masks[c])
    p.close()


class _Event:
    """Stands in for a CUDA event: records when it is waited on."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def synchronize(self):
        self.log.append(self.name)


def test_a_held_slot_is_refilled_only_after_its_copy():
    """The hazard of asynchronous copies: `submit` into a slot whose copy
    event is held waits on that event first, and only then packs."""
    images = np.arange(6 * 2 * 2 * 3, dtype=np.uint8).reshape(6, 2, 2, 3)
    masks = images[..., 0]
    p = native.BatchPacker(images, masks, batch=2, slots=2)
    log = []
    p.submit(np.array([0, 1]))
    p.get()
    p.hold(_Event(log, "copy of slot 0"))
    p.submit(np.array([2, 3]))                 # slot 1: nothing held
    assert log == []
    p.get()
    p.hold(_Event(log, "copy of slot 1"))
    p.submit(np.array([4, 5]))                 # slot 0 again
    assert log == ["copy of slot 0"]
    img, _ = p.get()
    np.testing.assert_array_equal(img.numpy(), images[[4, 5]])
    p.submit(np.array([1, 0]))                 # slot 1 again
    assert log == ["copy of slot 0", "copy of slot 1"]
    p.close()


@pytest.fixture(scope="module")
def data():
    return make_synthetic_videos(num_motions=2, num_views=3, num_frames=5,
                                 ref_size=32, n_gauss=20, seed=0, device="cpu")


def test_trainer_uses_packer(data, monkeypatch):
    """With the device-resident dataset off, sample_batch gathers through
    the packer and prefetches the next batch; every batch's rows are the
    flat gather of its (motion, view, frame)."""
    monkeypatch.setenv("DIMO_DEVICE_DATA", "0")
    images, masks, _ = data
    tr = TTrainer(t_opt(batch_size=2), *data, device="cpu")
    assert tr._dev_images is None
    flat_i = images.reshape((-1,) + images.shape[3:])
    flat_m = masks.reshape((-1,) + masks.shape[3:])
    kept = []
    for k in range(4):
        meta = tr._pending_meta
        batch, shape = tr.sample_batch()
        assert tr._packer is not None and tr._pending_meta is not None
        if meta is not None:
            np.testing.assert_array_equal(batch["gt_image"].numpy(),
                                          flat_i[meta["flat"]])
            np.testing.assert_array_equal(batch["gt_mask"].numpy(),
                                          flat_m[meta["flat"]])
        kept.append((meta, batch))
    # the batches are copies: later packing does not change them
    for meta, batch in kept[1:]:
        np.testing.assert_array_equal(batch["gt_image"].numpy(),
                                      flat_i[meta["flat"]])
    # a meta set by a caller replaces the prefetched one, frames and all
    meta = tr._sample_meta()
    tr._pending_meta = dict(meta)
    batch, _ = tr.sample_batch()
    np.testing.assert_array_equal(batch["gt_image"].numpy(),
                                  flat_i[meta["flat"]])
    batch, _ = tr.sample_batch()         # and the prefetch resumes
    assert tr._packer_pending is tr._pending_meta


@pytest.mark.parametrize("mode,on_device", [("auto", True), ("1", True),
                                             ("0", False)])
def test_device_data_override(data, monkeypatch, mode, on_device):
    monkeypatch.setenv("DIMO_DEVICE_DATA", mode)
    tr = TTrainer(t_opt(), *data, device="cpu")
    assert (tr._dev_images is not None) == on_device


def test_host_batches_are_the_reference_trainers(data, monkeypatch):
    """Both trainers with their datasets on the host (their packers): the
    same seed gives the same batches, frames and all."""
    from dimo_tpu.presets import tiny_synthetic_opt as j_opt
    from dimo_tpu.train.loop import Trainer as JTrainer
    monkeypatch.setenv("DIMO_DEVICE_DATA", "0")
    jt = JTrainer(j_opt(batch_size=2), *data)
    keys = ("gt_image", "gt_mask", "times", "latent_idx", "mse_w")
    j_batches = []
    for _ in range(3):
        jb, jshape = jt.sample_batch()
        # copied at once: on the CPU backend `jnp.asarray` may keep the
        # packer's slot as it is, and the slot is refilled two batches on
        j_batches.append(({k: np.array(jb[k]) for k in keys}
                          | {"camera": jb["camera"]}, jshape))
    assert jt._packer is not None
    tt = TTrainer(t_opt(batch_size=2), *data, device="cpu")
    t_batches = [tt.sample_batch() for _ in range(3)]
    assert tt._packer is not None
    for (jb, jshape), (tb, tshape) in zip(j_batches, t_batches):
        assert jshape == tshape == (2, 2, 2)
        for k in keys:
            np.testing.assert_array_equal(np.asarray(tb[k]), jb[k], err_msg=k)
        np.testing.assert_array_equal(
            np.stack([c.full_proj for c in tb["camera"]]),
            np.asarray(jb["camera"].full_proj))


def test_packer_probe_times_both_routes(monkeypatch):
    """`bench_train_torch.py --packer_probe` on the CPU at a small size:
    both routes timed, the override restored, the artifact's host batch
    keys filled."""
    import bench_train_torch
    monkeypatch.setenv("DIMO_DEVICE_DATA", "auto")
    packer_ms, numpy_ms = bench_train_torch.packer_probe(
        2, 2, torch.device("cpu"), ref_size=32, iters=2)
    assert packer_ms > 0 and numpy_ms > 0
    import os
    assert os.environ["DIMO_DEVICE_DATA"] == "auto"
    args = bench_train_torch.parse_args(["--packer_probe"])
    art = bench_train_torch.artifact(args, 0.5, 3.0, packer_ms, numpy_ms)
    assert (art["host_batch_packer_ms"], art["host_batch_numpy_ms"]) == \
        (packer_ms, numpy_ms)
