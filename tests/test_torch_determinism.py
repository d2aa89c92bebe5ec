"""The port's scatter-adds sum in a fixed order, and a training run gives
the same bits twice, as the reference's does, on the CPU.

* The plain versions of K4 (`gather_small_cols_bwd_plain`), K6
  (`gather_small_bwd_plain`) and the strip path's row scatter
  (`gather_rows_bwd`) against the JAX package's VJPs of
  `gather_small_cols`, `gather_small` and `gather_rows` (its Pallas
  kernels in interpret mode, forced by tests/conftest.py, for M <= 1024;
  its plain one-hot product above). Tolerance: 1e-5 of each entry's sum of
  |g| over the sites that land on it (the reference splits each value into
  bf16 hi + lo, ~2^-17 relative, and sums in another order). The
  reference's `gather_rows` VJP differences a running cumsum, whose
  rounding grows with everything summed before a row, so the row scatter
  is held to 1e-5 of each entry's |g| mass against an exact float64 sum,
  and to 1e-5 of the column's whole |g| against the reference (as
  test_torch_composite_bwd.py holds it).
* The plain versions against numpy float32 loops that follow the kernels'
  code step by step (`csrc/smallgather.cu`: the table route's sorted
  chunks, runs, block tables and fixed combine, on the grid the card runs,
  which follows the shape alone; the sorted route's tiles, pieces and the
  second pass's fold; the row scatter's chunk sums, in chunk order): equal
  bit for bit, since both sum the same float32 terms in the same order.
  The row scatter over the live slots of strip lists (`count`) against
  the same over every slot, when the slots past a count carry K3's zeros:
  equal bit for bit.
* Two fresh `Trainer`s with one seed, through densifications, the FPS
  anneal, finish_s1's prune and s1 -> s2: the same parameters, Adam
  moments, step losses and checkpoint bytes.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.ops import smallgather as jsg
from dimo_tpu.ops.rasterizer import gather as jgather

from dimo_tpu_torch.io.synthetic import make_synthetic_videos
from dimo_tpu_torch.ops import smallgather as tsg
from dimo_tpu_torch.ops.rasterizer import gather as tgather
from dimo_tpu_torch.presets import tiny_synthetic_opt
from dimo_tpu_torch.train.loop import Trainer
from dimo_tpu_torch.utils import diagnostics

from torch_parity import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _mass_close(got, ref, g_abs_mass, what):
    """|got - ref| <= 1e-5 of each entry's sum of |g| (and exact zeros
    where nothing lands)."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    bad = err > 1e-5 * g_abs_mass
    assert not bad.any(), (what, float(err.max()), int(bad.sum()))


def _rows_mass(g, idx, m):
    """(m, D) float64 sum of |g| (S, D) over the sites of each row."""
    flat = idx.reshape(-1)
    ok = (flat >= 0) & (flat < m)
    out = np.zeros((m, g.shape[-1]), np.float64)
    np.add.at(out, flat[ok], np.abs(g.reshape(-1, g.shape[-1])[ok]))
    return out


def _indices(rng, m, s, kind):
    if kind == "uniform":
        return rng.randint(0, m, s).astype(np.int32)
    if kind == "hot":                    # a few rows take most of the sites
        idx = rng.randint(0, m, s).astype(np.int32)
        idx[rng.rand(s) < 0.6] = min(3, m - 1)
        return idx
    if kind == "edges":                  # -1 and m among them
        idx = rng.randint(-1, m + 1, s).astype(np.int32)
        idx[:5], idx[-5:] = -1, m
        return idx
    raise ValueError(kind)


# (m, d, sites, indices): rows with many hits, indices -1 and m, S = 0,
# and tables on both sides of the 223 KB route limit at D = 11 (5,189 rows
# fit a block's shared memory, 5,190 do not)
ROWS = [(512, 11, 3000, "hot"), (64, 16, 2500, "edges"),
        (1, 11, 700, "uniform"), (5189, 11, 2000, "edges"),
        (5190, 11, 2000, "hot"), (1500, 3, 1200, "uniform")]


@pytest.mark.parametrize("m,d,s,kind", ROWS)
def test_k6_plain_matches_jax_vjp(m, d, s, kind):
    rng = np.random.RandomState(m + s)
    table = rng.randn(m, d).astype(np.float32)
    idx = _indices(rng, m, s, kind)
    g = rng.randn(s, d).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jsg.gather_small(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(g))
    got = tsg.gather_small_bwd_plain(_t(g), _t(idx), m)
    assert got.shape == (m, d) and got.dtype == torch.float32
    _mass_close(got.numpy(), np.asarray(ref), _rows_mass(g, idx, m), "K6")


@pytest.mark.parametrize("m,d,s,kind", ROWS)
def test_k4_plain_matches_jax_vjp(m, d, s, kind):
    rng = np.random.RandomState(m + 2 * s)
    table = rng.randn(d, m).astype(np.float32)
    idx = _indices(rng, m, s, kind).reshape(1, s)
    g = rng.randn(d, 1, s).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jsg.gather_small_cols(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(g))
    got = tsg.gather_small_cols_bwd_plain(_t(g), _t(idx), m)
    assert got.shape == (d, m) and got.dtype == torch.float32
    mass = _rows_mass(g.reshape(d, s).T, idx, m).T
    _mass_close(got.numpy(), np.asarray(ref), mass, "K4")


@pytest.mark.parametrize("m,t,c,kind", [(40, 12, 30, "uniform"),
                                        (300, 16, 64, "hot"),
                                        (3000, 8, 300, "edges")])
def test_row_scatter_matches_jax_vjp(m, t, c, kind):
    rng = np.random.RandomState(m + t)
    attrs = rng.randn(m, 16).astype(np.float32)
    idx = _indices(rng, m, t * c, kind).reshape(t, c)
    g = rng.randn(t, c, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jgather.gather_rows(a, jnp.asarray(idx)),
                     jnp.asarray(attrs))
    (ref,) = vjp(jnp.asarray(g))
    got = tgather.gather_rows_bwd(_t(g), _t(idx), m)
    assert got.shape == (m, 16) and got.dtype == torch.float32
    flat, g2 = idx.reshape(-1), g.reshape(-1, 16).astype(np.float64)
    ok = (flat >= 0) & (flat < m)
    exact = np.zeros((m, 16), np.float64)
    np.add.at(exact, flat[ok], g2[ok])
    _mass_close(got.numpy(), exact, _rows_mass(g, idx, m), "row scatter")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * float(np.abs(g2[ok]).sum(0).max()))


def test_scatters_of_no_sites_are_zero():
    g = torch.zeros((0, 11))
    idx = torch.zeros((0,), dtype=torch.int32)
    for m in (512, 5190):                # both routes
        assert torch.equal(tsg.gather_small_bwd_plain(g, idx, m),
                           torch.zeros((m, 11)))
        assert torch.equal(tsg.gather_small_cols_bwd_plain(g.T, idx, m),
                           torch.zeros((11, m)))
    assert torch.equal(tgather.gather_rows_bwd(
        torch.zeros((3, 0, 16)), torch.zeros((3, 0), dtype=torch.int32), 9),
        torch.zeros((9, 16)))


# --- numpy float32 loops in the kernels' order ---------------------------

def _np_tables(g, idx, m, blocks, per_block):
    """scatter_block_kernel + combine_tables_kernel, step by step: each
    block's chunks of CHUNK sites, keys (index << 10 | place) sorted, each
    run summed in site order (by the run's first threads, a column group
    each, in the kernel) into the block's table; then warp w adds blocks
    w, w + 32, ... and warp 0 the 32 sums."""
    s, d = g.shape
    no_key = 0xFFFFFFFF
    part = np.zeros((blocks, m, d), np.float32)
    for b in range(blocks):
        tab = np.zeros((m, d), np.float32)
        b0, b1 = b * per_block, min(s, (b + 1) * per_block)
        for c0 in range(b0, b1, tsg.CHUNK):
            n = min(tsg.CHUNK, b1 - c0)
            keys = [no_key] * tsg.CHUNK
            for t in range(n):
                if 0 <= idx[c0 + t] < m:
                    keys[t] = (int(idx[c0 + t]) << 10) | t
            keys.sort()
            for t in range(tsg.CHUNK):
                k = keys[t]
                j = k >> 10
                if k == no_key or (t > 0 and keys[t - 1] >> 10 == j):
                    continue
                acc = np.zeros(d, np.float32)
                q = t
                while q < tsg.CHUNK and keys[q] >> 10 == j:
                    acc = acc + g[c0 + (keys[q] & 1023)]
                    q += 1
                tab[j] = tab[j] + acc
        part[b] = tab
    red = np.zeros((32, m, d), np.float32)
    for b in range(blocks):
        red[b % 32] = red[b % 32] + part[b]
    out = red[0].copy()
    for w in range(1, 32):
        out = out + red[w]
    return out


def _np_sorted(g, idx, m):
    """segment_tiles_kernel + segment_runs_kernel, step by step, on the
    stable sort of the indices."""
    s, d = g.shape
    order = np.argsort(idx, kind="stable")
    keys = idx[order]
    tile_n = tsg.SEG_TILE
    tiles = -(-s // tile_n)
    out = np.zeros((m, d), np.float32)
    head = np.zeros((tiles, d), np.float32)
    tail = np.zeros((tiles, d), np.float32)
    for tile in range(tiles):
        p0, p1 = tile * tile_n, min(s, (tile + 1) * tile_n)
        from_before = p0 > 0 and keys[p0 - 1] == keys[p0]
        goes_on = p1 < s and keys[p1] == keys[p1 - 1]
        acc = np.zeros(d, np.float32)
        j, first = keys[p0], p0
        for p in range(p0, p1):
            if keys[p] != j:
                if first == p0 and from_before:
                    head[tile] = acc
                elif 0 <= j < m:
                    out[j] = acc
                acc = np.zeros(d, np.float32)
                j, first = keys[p], p
            acc = acc + g[order[p]]
        if goes_on:
            tail[tile] = acc
            if first == p0 and from_before:
                head[tile] = acc
        elif first == p0 and from_before:
            head[tile] = acc
        elif 0 <= j < m:
            out[j] = acc
    for tile in range(tiles):
        p0, p1 = tile * tile_n, min(s, (tile + 1) * tile_n)
        j = keys[p1 - 1]
        if p1 >= s or keys[p1] != j or (p0 > 0 and keys[p0 - 1] == j):
            continue
        acc = tail[tile].copy()
        for u in range(tile + 1, tiles):
            acc = acc + head[u]
            e = min(s, (u + 1) * tile_n)
            if e >= s or keys[e] != j:
                break
        if 0 <= j < m:
            out[j] = acc
    return out


def _np_chunked(g, idx, m, live=None):
    """chunk_runs_kernel + run_sums_kernel + sum_rows_kernel, step by step:
    in each chunk of CHUNK flat slots, each row's live slots summed in slot
    order from 0; then each row's chunk sums added in chunk order from 0."""
    s, a = g.shape
    parts = {}
    for c0 in range(0, s, tsg.CHUNK):
        sums = {}
        for q in range(c0, min(s, c0 + tsg.CHUNK)):
            j = int(idx[q])
            if (live is None or live[q]) and 0 <= j < m:
                sums[j] = sums.get(j, np.zeros(a, np.float32)) + g[q]
        for j, v in sums.items():
            parts.setdefault(j, []).append(v)
    out = np.zeros((m, a), np.float32)
    for j, vs in parts.items():
        acc = np.zeros(a, np.float32)
        for v in vs:
            acc = acc + v
        out[j] = acc
    return out


# (m, d, sites, indices, plan): the plan is (blocks, sites a block) of
# the table route, a multiple of 32 as `rows_bwd_plan` makes it; None: the
# default, `rows_bwd_plan`'s grid, which the card runs
ORDERED = [(512, 11, 3000, "hot", None),
           (512, 11, 5000, "uniform", (7, 736)),
           (64, 3, 2100, "edges", (40, 64)),
           (1, 4, 3000, "uniform", (3, 1024)),
           (5190, 11, 2000, "hot", None), (6000, 2, 900, "edges", None),
           (7000, 3, 1000, "uniform", None)]


@pytest.mark.parametrize("m,d,s,kind,plan", ORDERED)
def test_plain_scatter_is_the_kernels_order_bit_for_bit(m, d, s, kind, plan):
    rng = np.random.RandomState(s + d)
    idx = _indices(rng, m, s, kind)
    g = (rng.randn(s, d) * np.exp(rng.randn(s, 1) * 3)).astype(np.float32)
    got = tsg.gather_small_bwd_plain(_t(g), _t(idx), m, plan).numpy()
    if tsg.rows_bwd_smem(m, d) <= tsg.SMEM_LIMIT:
        blocks, per = plan or tsg.rows_bwd_plan(m, d, s)[1:]
        want = _np_tables(g, idx, m, blocks, per)
    else:
        want = _np_sorted(g, idx, m)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # K4 is the same sums on the transposed layout
    cols = tsg.gather_small_cols_bwd_plain(_t(g.T.copy()), _t(idx), m, plan)
    np.testing.assert_array_equal(_bits(cols.numpy().T), _bits(want))


@pytest.mark.parametrize("m,s,kind", [(50, 2000, "hot"), (3000, 2500, "edges"),
                                      (2, 1000, "uniform")])
def test_row_scatter_is_the_sorted_order_bit_for_bit(m, s, kind):
    """The row scatter over every slot sums in its kernels' order (the
    chunk sums of each row, in chunk order), bit for bit."""
    rng = np.random.RandomState(m)
    idx = _indices(rng, m, s, kind)
    g = rng.randn(s, 16).astype(np.float32)
    got = tgather.gather_rows_bwd(_t(g).reshape(4, -1, 16),
                                  _t(idx).reshape(4, -1), m)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(_np_chunked(
        g, idx, m)))


def test_the_table_routes_order_is_its_plans():
    """Another grid sums in another order: the plan matters, and the
    plain version follows it (so the card is held to its own plan)."""
    rng = np.random.RandomState(5)
    idx = _indices(rng, 512, 6000, "hot")
    g = (rng.randn(6000, 11) * np.exp(rng.randn(6000, 1) * 4)).astype(
        np.float32)
    a = tsg.gather_small_bwd_plain(_t(g), _t(idx), 512, (1, 6000))
    b = tsg.gather_small_bwd_plain(_t(g), _t(idx), 512, (24, 256))
    assert not torch.equal(a, b)
    np.testing.assert_array_equal(_bits(b.numpy()),
                                  _bits(_np_tables(g, idx, 512, 24, 256)))


def test_the_cpus_default_plan_is_the_cards_at_the_lbs_shape():
    """K4 and K6 at the LBS shape ((11, 512) table, 4 x 100,000 sites): the
    plain versions' default grid is the one the card runs, 132 blocks of
    3,040 sites, whatever card it is, and they sum in its order."""
    assert tsg.rows_bwd_plan(512, 11, 400_000) == ("tables", 132, 3040)
    assert tsg.cols_bwd_plan(11, 512, 400_000) == ("tables", 132, 3040)
    rng = np.random.RandomState(400)
    idx = _indices(rng, 512, 400_000, "hot")
    g = rng.randn(400_000, 11).astype(np.float32)
    want = _np_tables(g, idx, 512, 132, 3040)
    got = tsg.gather_small_bwd(_t(g), _t(idx), 512)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    cols = tsg.gather_small_cols_bwd(_t(g.T.copy()).reshape(11, 4, -1),
                                     _t(idx).reshape(4, -1), 512)
    np.testing.assert_array_equal(_bits(cols.numpy().T), _bits(want))


def _strip_slots(rng, n_strips, cap, m, counts, dup_rows=False):
    """Strip lists as the binning makes them: strip t lists count[t]
    distinct rows of [0, m - 1) (the last row is the padding row), then
    the padding row to the capacity; K3-shaped gradients, 0 past each
    count, with some -0.0 among the live ones. `dup_rows`: rows drawn with
    repeats inside a strip."""
    idx = np.full((n_strips, cap), m - 1, np.int32)
    g = np.zeros((n_strips, cap, 16), np.float32)
    for t, c in enumerate(counts):
        c = min(c, cap)
        idx[t, :c] = (rng.randint(0, m - 1, c) if dup_rows
                      else rng.permutation(m - 1)[:c])
        g[t, :c] = rng.randn(c, 16) * np.exp(rng.randn(c, 1) * 3)
        g[t, :c][rng.rand(c, 16) < 0.05] = -0.0
    return g, idx


# (strips, capacity, rows, counts, rows repeated in a strip): the capacity
# of 1,024 puts one strip in each chunk; 700 and 1,500 cut strips across
# chunks; counts of 0 and of the capacity
LIVE = [(6, 1024, 3000, [1024, 0, 517, 3, 1024, 900], False),
        (5, 700, 1000, [700, 0, 12, 699, 350], False),
        (3, 1500, 2500, [1500, 1499, 0], True),
        (4, 64, 50, [0, 0, 0, 0], False)]


@pytest.mark.parametrize("n_strips,cap,m,counts,dup", LIVE)
def test_row_scatter_live_slots_match_the_all_slot_route(n_strips, cap, m,
                                                         counts, dup):
    """Over the live slots (`count`) the row scatter gives the bits of the
    all-slot route on K3-shaped gradients, and both are a numpy loop in
    the kernels' order, bit for bit."""
    rng = np.random.RandomState(cap + m)
    g, idx = _strip_slots(rng, n_strips, cap, m, counts, dup)
    count = np.array(counts, np.int32)
    live = (np.arange(cap)[None, :] < count[:, None]).reshape(-1)
    got = tgather.gather_rows_bwd(_t(g), _t(idx), m, _t(count))
    every = tgather.gather_rows_bwd(_t(g), _t(idx), m)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(every.numpy()))
    want = _np_chunked(g.reshape(-1, 16), idx.reshape(-1), m, live)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


# (indices inside the counts, counts): -1 and N+1 among the live slots,
# every live slot on one row, a count of 0 everywhere, counts at the
# capacity
EDGES = [("-1 and N+1", [40, 64, 0]), ("one row", [64, 64, 64]),
         ("no live slot", [0, 0, 0]), ("every slot live", [64, 64, 64])]


@pytest.mark.parametrize("kind,counts", EDGES)
def test_row_scatter_edge_cases_are_its_order_bit_for_bit(kind, counts):
    rng = np.random.RandomState(len(kind))
    m, cap = 30, 64
    idx = rng.randint(0, m, (3, cap)).astype(np.int32)
    if kind == "-1 and N+1":
        idx[:, :5], idx[:, 5:9] = -1, m + 1
    if kind == "one row":
        idx[...] = 7
    g = rng.randn(3, cap, 16).astype(np.float32)
    count = np.array(counts, np.int32)
    live = (np.arange(cap)[None, :] < count[:, None]).reshape(-1)
    got = tgather.gather_rows_bwd(_t(g), _t(idx), m, _t(count))
    want = _np_chunked(g.reshape(-1, 16), idx.reshape(-1), m, live)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if kind == "no live slot":
        assert not got.any()


@pytest.mark.parametrize("n_strips,cap,m,counts,dup", LIVE[:3])
def test_row_scatter_over_live_slots_matches_jax_vjp(n_strips, cap, m,
                                                     counts, dup):
    """The reference's `gather_rows` VJP of the same K3-shaped gradients
    (every slot; zeros past the counts), within the tolerance of
    test_row_scatter_matches_jax_vjp."""
    rng = np.random.RandomState(cap + 2 * m)
    g, idx = _strip_slots(rng, n_strips, cap, m, counts, dup)
    attrs = rng.randn(m, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jgather.gather_rows(a, jnp.asarray(idx)),
                     jnp.asarray(attrs))
    (ref,) = vjp(jnp.asarray(g))
    got = tgather.gather_rows_bwd(_t(g), _t(idx), m,
                                  _t(np.array(counts, np.int32)))
    flat, g2 = idx.reshape(-1), g.reshape(-1, 16).astype(np.float64)
    exact = np.zeros((m, 16), np.float64)
    np.add.at(exact, flat, g2)
    _mass_close(got.numpy(), exact, _rows_mass(g, idx, m), "row scatter")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * float(np.abs(g2).sum(0).max()))


# --- two trainers, one seed ----------------------------------------------

# the trainer cadence cut as chip_smoke.py's phase 7b cuts it: densify at
# 4 and 8, opacity reset at 10, FPS anneal at 12, finish_s1's prune, s1 ->
# s2, two s2 steps
TWIN_OPT = dict(
    ref_size=64, H=64, W=64, num_cpts=24, latent_code_dim=8,
    capacity_s1=256, num_pts_per_cpt=4, tile_capacity=64, batch_size=2,
    FPS_iter=12, density_start_iter=2, density_end_iter=10,
    densification_interval=4, opacity_reset_interval=10, save_inter=20)


def test_two_trainers_with_one_seed_are_bit_identical(tmp_path):
    images, masks, meta = make_synthetic_videos(
        num_motions=2, num_views=3, num_frames=5, ref_size=64, seed=0,
        device="cpu")
    runs = []
    for r in range(2):
        opt = tiny_synthetic_opt(save_path=str(tmp_path / f"run{r}"),
                                 **TWIN_OPT)
        losses = []
        tr = Trainer(opt, images, masks, meta, device="cpu",
                     log_fn=lambda st, step, m, trainer: losses.append(
                         (st, step, float(m["loss"]))))
        tr.train_dynamic(13, 2)
        runs.append((losses, diagnostics.run_fingerprint(tr),
                     int(tr.state.aux.active.sum())))
    (la, fa, na), (lb, fb, nb) = runs
    assert [x[:2] for x in la] == [("s1", i) for i in range(1, 14)] + [
        ("s2", 1), ("s2", 2)]
    assert la == lb and na == nb
    assert {"s1/point_cloud.ply", "s1/timenet.pth", "s2/timenet.pth",
            "s2/latent_codes.npz", "s2/point_cloud_c.ply"} <= set(fa["files"])
    assert diagnostics.fingerprint_diff(fa, fb) == {}
    # the comparison sees a difference of one bit, and a file's byte
    fb["mu"]["xyz"].view(-1)[0] = torch.nextafter(
        fb["mu"]["xyz"].view(-1)[0], torch.tensor(np.inf))
    name = sorted(fb["files"])[0]
    fb["files"][name] = fb["files"][name][:-1] + bytes(
        [fb["files"][name][-1] ^ 1])
    diff = diagnostics.fingerprint_diff(fa, fb)
    assert set(diff) == {"mu", "files"} and diff["files"] == [name]
    assert 0 < diff["mu"]["xyz"] < 1e-6
