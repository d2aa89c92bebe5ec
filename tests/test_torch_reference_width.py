"""The port at full width on the CPU against the reference vectors that
`tests/make_torch_reference.py` made with the JAX package
(`tests/golden/torch_reference_{frame,vjp,step}.npz`).

The flagship scene (100,000 Gaussians, 512 control points, latent 32) at
512^2, capacity 1024, the frame in ch7 and ch3 and the frame's VJP,
through `dimo_tpu_torch/reference_check.py` at its limits (the strip
lists the reference's but for depth-tied neighbours; over the
reference's lists each plane by `torch_parity.assert_close_except_cut_flips`
at 1e-4 x scale for ch7 and 5e-4 for ch3 with 0.5% of the pixels allowed
over, over the port's own lists the same pixel count; overflow and
overflow_max equal, at most 10 radii apart; every gradient leaf within
1e-3 relative L2). The full-width step (16 renders with
LPIPS, about 1-2 minutes here) is held on the card by `chip_smoke.py
--phase reference`; its CPU result is recorded in PERF.md.

The writer and the reader of the files are held against each other at
2,048 Gaussians in `tests/test_torch_reference_layout.py`.
"""
import functools
import os

import numpy as np
import pytest

from dimo_tpu_torch import reference_check as rc

from test_torch_math import _imports, _port_files
from torch_parity import assert_close_except_cut_flips, one_torch_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def golden(part: str) -> tuple:
    """(meta, arrays) of a committed file."""
    return rc.read_vectors(rc.path_of(part))


@pytest.fixture(scope="module")
def frames():
    """The port's ch7 frame (7), and the frame composited over the
    reference's strip lists in ch7 and ch3 ("given7", "given3"; the ch3
    frame's lists and overflow are the ch7 frame's, the same inputs)."""
    scene = rc.port_scene(rc.FULL, "cpu")
    ref = golden("frame")[1]
    given = (ref["lists/idx"], ref["lists/count"])
    out = {7: rc.port_frame(rc.FULL, "cpu", 7, scene)}
    out.update({f"given{ch}": rc.port_frame(rc.FULL, "cpu", ch, scene, given)
                for ch in (7, 3)})
    return out


@pytest.fixture(scope="module")
def vjp():
    return rc.port_vjp(rc.FULL, "cpu")


def test_reference_check_imports_neither_jax_nor_dimo_tpu():
    path = os.path.join(os.path.dirname(rc.__file__), "reference_check.py")
    assert path in _port_files()
    for mod in _imports(path):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "dimo_tpu"), mod


@pytest.mark.parametrize("part", rc.PARTS)
def test_files_name_the_scene_they_were_made_from(part):
    meta, _ = golden(part)
    assert meta["part"] == part
    assert rc.Spec.from_json(meta["spec"]) == rc.FULL
    assert meta["scene_hash"] == rc.scene_hash(rc.scene_numpy(rc.FULL),
                                               rc.FULL)
    # another seed names another scene
    other = rc.Spec(timenet_seed=2)
    assert meta["scene_hash"] != rc.scene_hash(rc.scene_numpy(other), other)


def test_files_are_small_and_store_no_input():
    total = sum(os.path.getsize(rc.path_of(p)) for p in rc.PARTS)
    assert total < 8 * 2**20, total
    big = {f"{p}/{k}": a.nbytes for p in rc.PARTS
           for k, a in golden(p)[1].items() if a.nbytes > rc.SKETCH_MIN_BYTES}
    # only the frame's planes, radii and KNN are larger than a sketch's
    # threshold: no weight, GT image or gradient is stored whole
    assert all(k.startswith("frame/") for k in big), big


@pytest.mark.parametrize("plane", rc.PLANES)
def test_full_width_ch7_plane_matches_reference(frames, plane):
    """Over the reference's strip lists, every pixel within the tolerance
    or one alpha-cut flip; over the port's own lists, which may trade the
    places of two neighbours at tied depths, the same pixel count."""
    ref = golden("frame")[1][f"ch7/{plane}"]
    tol = rc.PLANE_TOL[7] * max(1.0, float(np.abs(ref).max()))
    assert_close_except_cut_flips(frames["given7"][plane], ref, tol, plane,
                                  max_px_frac=rc.MAX_PX_FRAC)
    d = rc.plane_diff(frames[7][plane], ref, tol)
    assert d["px_over_tol"] <= d["px_limit"], d


def test_full_width_ch3_image_matches_reference(frames):
    ref = golden("frame")[1]["ch3/image"]
    tol = rc.PLANE_TOL[3] * max(1.0, float(np.abs(ref).max()))
    assert_close_except_cut_flips(frames["given3"]["image"], ref, tol, "ch3",
                                  max_px_frac=rc.MAX_PX_FRAC)


def test_full_width_lists_match_reference_up_to_tied_neighbours(frames):
    ref, out = golden("frame")[1], frames[7]
    rows = rc.list_rows(ref["lists/idx"], ref["lists/count"],
                        out["lists_idx"], out["lists_count"],
                        out["list_depth"])
    assert all(r["ok"] for r in rows), rows
    # the given lists reach the compositor: the port's lists come back
    # its own, the planes follow the given ones
    np.testing.assert_array_equal(frames["given7"]["lists_idx"],
                                  out["lists_idx"])


@pytest.mark.parametrize("ch", [7, 3])
def test_full_width_overflow_equals_reference(frames, ch):
    ref = golden("frame")[1]
    # the flagship frame overflows its strips: capacity truncation is
    # part of what both packages must do alike
    assert ref[f"ch{ch}/overflow"].item() > 0
    assert ref[f"ch{ch}/overflow_max"].item() > rc.FULL.capacity
    for key in ("overflow", "overflow_max"):
        got = frames[7 if ch == 7 else "given3"][key].item()
        assert got == ref[f"ch{ch}/{key}"].item(), key


def test_full_width_radii_knn_and_control_points(frames):
    ref = golden("frame")[1]
    out = frames[7]
    assert int((out["radii"] != ref["ch7/radii"]).sum()) <= rc.RADII_DIFF_MAX
    np.testing.assert_allclose(out["cpts_t"], ref["ch7/cpts_t"], rtol=0,
                               atol=rc.CPTS_ATOL)
    # the control points moved
    c0 = rc.scene_numpy(rc.FULL)["c_xyz"]
    assert float(np.abs(ref["ch7/cpts_t"] - c0).max()) > 1e-3
    ties = ref["knn/near_ties"]
    assert 0 < ties.size < 1000
    np.testing.assert_array_equal(out["knn_idx"][:, ties],
                                  ref["knn/idx"][:, ties])


def _vjp_leaves():
    return sorted({k.split("/")[1] for k in golden("vjp")[1]})


@pytest.mark.parametrize("leaf", _vjp_leaves())
def test_full_width_vjp_leaf_matches_reference(vjp, leaf):
    ref = {k: v for k, v in golden("vjp")[1].items()
           if k.split("/")[1] == leaf}
    [r] = rc.grad_rows(ref, {leaf: vjp[leaf]}, rc.FULL.sketch_seed, "vjp")
    assert r["ok"], r
    norm = ref.get(f"grad/{leaf}/norm")
    if norm is not None:        # the sketch carries the leaf's own size
        got = np.linalg.norm(vjp[leaf].astype(np.float64))
        assert abs(got - float(norm)) <= rc.GRAD_REL_L2 * float(norm)


def test_sketch_reads_the_relative_l2():
    """The sketch's estimate of |a - b| / |b| within 30% of the exact one
    (64 projections: about +-9%), at a leaf past the threshold."""
    rng = np.random.RandomState(0)
    b = rng.randn(40_000).astype(np.float32)
    a = b + 1e-3 * rng.randn(40_000).astype(np.float32)
    [r] = rc.grad_rows(rc.sketch({"x": b}, 5), {"x": a}, 5, "t")
    exact = np.linalg.norm(a.astype(np.float64) - b) / np.linalg.norm(b)
    assert r["what"].endswith("(sketch)")
    assert abs(r["value"] - exact) <= 0.3 * exact
