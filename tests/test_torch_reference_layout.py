"""The reference vectors' writer and reader against each other: at 2,048
Gaussians, 32 control points, latent 8, 64^2 and a 2 x 1 x 2 step, the
generator's own functions (`tests/make_torch_reference.py`) run
`dimo_tpu` (Pallas in interpret mode) and write the three files, and the
port's checker (`dimo_tpu_torch/reference_check.py`) reads them and
passes every limit; and the writer gives the same bytes for the same
arrays. (Apart from `test_torch_reference_width.py`, whose full-width
renders take most of a worker's minute.)
"""
import numpy as np

import make_torch_reference as mk
from dimo_tpu_torch import reference_check as rc

from torch_parity import one_torch_thread  # noqa: F401

SMALL = rc.Spec(n_gauss=2048, n_cpts=32, latent_dim=8, width=64, height=64,
                capacity=128, shape=(2, 1, 2))


def test_writer_is_byte_stable_and_round_trips(tmp_path):
    rng = np.random.RandomState(1)
    arrays = {"a/plane": rng.rand(3, 8, 8).astype(np.float32),
              "a/n": np.int64(7), "b/idx": rng.randint(0, 9, (4, 5)),
              "c": rng.rand(6)}
    p1, p2 = str(tmp_path / "1.npz"), str(tmp_path / "2.npz")
    rc.write_vectors(p1, {"x": 1}, arrays)
    meta, back = rc.read_vectors(p1)
    assert meta["x"] == 1 and meta["shuffled"] == {"a/plane": [3, 8, 8]}
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == np.asarray(v).dtype
        assert back[k].shape == np.shape(v)
    rc.write_vectors(p2, meta, back)
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_writer_and_reader_agree_at_2048_gaussians(tmp_path):
    """The generator's functions under JAX write the three files at a small
    size; the port's checker reads them and passes every limit."""
    mk.make(SMALL, folder=str(tmp_path), log=lambda *_: None)
    rows = rc.check("cpu", folder=str(tmp_path), log=lambda *_: None)
    assert {r["what"].split()[0] for r in rows} == set(rc.PARTS)
    assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]
    # every leaf of the step's gradient was compared
    n_leaves = len(rc.port_grads(rc.port_scene(SMALL, "cpu")[1]))
    assert sum(" grad " in r["what"] and r["what"].startswith("step")
               for r in rows) == n_leaves
    # the moved control points and every loss term were read
    assert any("cpts_t" in r["what"] for r in rows)
    assert sum(r["what"].startswith("step ") and "|err|" in r["what"]
               for r in rows) >= 12
