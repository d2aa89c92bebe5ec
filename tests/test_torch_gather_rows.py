"""Parity of the port's row-layout small gather (`gather_small`, kernels
K5 and K6 through their plain versions) with the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (forced by
tests/conftest.py) for M <= 1024 and its plain one-hot product above.
Tolerances:
  * forward vs the reference: 2e-5 of max|table| (the reference gathers a
    bf16 hi + lo split, ~2^-17 relative; the port is exact); vs indexing:
    equal;
  * backward vs `jax.vjp` of the reference: 1e-4 of max|g| times the most
    sites that land on one row (the reference splits the cotangent the
    same way before it sums); vs torch.autograd of `table[idx]`: 1e-6 of
    that scale (a one-hot product against an index_add: float32 sum
    order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.ops import smallgather as jsg

from dimo_tpu_torch.ops import smallgather as tsg

from torch_parity import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(m, d, shape, seed):
    rng = np.random.RandomState(seed)
    table = rng.randn(m, d).astype(np.float32)
    idx = rng.randint(0, m, shape).astype(np.int32)
    g = rng.randn(*shape, d).astype(np.float32)
    return table, idx, g


CASES = [(33, 7, (5, 4)), (512, 11, (4, 300)), (1500, 3, (6, 50))]


@pytest.mark.parametrize("m,d,shape", CASES)
def test_gather_small_matches_jax_and_indexing(m, d, shape):
    table, idx, _ = _case(m, d, shape, m + d)
    ref = np.asarray(jsg.gather_small(jnp.asarray(table), jnp.asarray(idx)))
    got = tsg.gather_small(_t(table), _t(idx))
    assert got.shape == (*shape, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-5 * float(np.abs(table).max()))
    np.testing.assert_array_equal(got.numpy(), table[idx])


@pytest.mark.parametrize("m,d,shape", CASES)
def test_gather_small_bwd_matches_jax_vjp_and_autograd(m, d, shape):
    table, idx, g = _case(m, d, shape, m + 2 * d)
    _, vjp = jax.vjp(lambda t: jsg.gather_small(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(g))
    got = tsg.gather_small_bwd_plain(_t(g), _t(idx), m)
    assert got.shape == (m, d)
    hits = np.bincount(idx.reshape(-1), minlength=m).max()
    scale = float(np.abs(g).max()) * hits
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4 * scale)
    t = _t(table).requires_grad_(True)
    t[_t(idx).long()].backward(_t(g))
    np.testing.assert_allclose(got.numpy(), t.grad.numpy(), rtol=0,
                               atol=1e-6 * scale)
    # autograd through the port's gather runs the same backward
    t2 = _t(table).requires_grad_(True)
    tsg.gather_small(t2, _t(idx)).backward(_t(g))
    assert torch.equal(t2.grad, got)


def test_gather_small_out_of_range_reads_zeros_and_adds_nothing():
    table, idx, g = _case(16, 5, (3, 40), 4)
    idx[0, :7] = 16                      # outside [0, M)
    idx[1, :5] = -1
    got = tsg.gather_small(_t(table), _t(idx)).numpy()
    bad = (idx < 0) | (idx >= 16)
    assert bad.sum() == 12 and np.all(got[bad] == 0)
    np.testing.assert_array_equal(got[~bad], table[idx[~bad]])
    # the reference's kernel reads zeros there too (an all-zero one-hot row)
    ref = np.asarray(jsg.gather_small(jnp.asarray(table), jnp.asarray(idx)))
    assert np.all(ref[bad] == 0)
    dt = tsg.gather_small_bwd_plain(_t(g), _t(idx), 16).numpy()
    want = np.zeros((16, 5), np.float64)
    for s, j in enumerate(idx.reshape(-1)):
        if 0 <= j < 16:
            want[j] += g.reshape(-1, 5)[s]
    np.testing.assert_allclose(dt, want, rtol=0, atol=1e-5)


def test_gather_small_repeated_indices_accumulate():
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    idx = np.array([2, 2, 2, 0, 2], np.int32)
    g = np.ones((5, 3), np.float32)
    t = _t(table).requires_grad_(True)
    out = tsg.gather_small(t, _t(idx))
    np.testing.assert_array_equal(out.detach().numpy(), table[idx])
    out.backward(_t(g))
    np.testing.assert_array_equal(
        t.grad.numpy(), np.array([[1] * 3, [0] * 3, [4] * 3, [0] * 3], np.float32))


def test_gather_small_without_grad_records_no_graph_and_rejects_bad_input():
    table, idx, _ = _case(8, 3, (10,), 1)
    t = _t(table).requires_grad_(True)
    with torch.no_grad():
        assert not tsg.gather_small(t, _t(idx)).requires_grad
    assert tsg.gather_small(t, _t(idx)).requires_grad
    with pytest.raises(ValueError, match=r"\(M, D\)"):
        tsg.gather_small(_t(table).reshape(-1), _t(idx))
    # empty index sets give empty rows and a zero table grad
    assert tsg.gather_small(_t(table), _t(idx[:0])).shape == (0, 3)
    assert not tsg.gather_small_bwd(torch.zeros(0, 3), _t(idx[:0]), 8).any()


# (m, d, shape, every index on one row): D = 1 and 16, S not a multiple of
# 4, every index equal, M = 1
EDGE_CASES = [(40, 1, (3, 301), False), (40, 16, (2, 64), False),
              (300, 11, (3, 301), False), (40, 11, (4, 75), True),
              (1, 11, (4, 50), False)]


def _edge_case(m, d, shape, same, seed):
    table, idx, g = _case(m, d, shape, seed)
    if same:
        idx[...] = m // 2
    return table, idx, g


@pytest.mark.parametrize("m,d,shape,same", EDGE_CASES)
def test_gather_small_edge_cases_match_jax_and_indexing(m, d, shape, same):
    table, idx, _ = _edge_case(m, d, shape, same, 7 * m + d)
    ref = np.asarray(jsg.gather_small(jnp.asarray(table), jnp.asarray(idx)))
    got = tsg.gather_small(_t(table), _t(idx))
    assert got.shape == (*shape, d)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=2e-5 * float(np.abs(table).max()))
    np.testing.assert_array_equal(got.numpy(), table[idx])


@pytest.mark.parametrize("m,d,shape,same", EDGE_CASES)
def test_gather_small_bwd_edge_cases_match_jax_vjp_and_autograd(m, d, shape,
                                                                same):
    table, idx, g = _edge_case(m, d, shape, same, 7 * m + 2 * d)
    _, vjp = jax.vjp(lambda t: jsg.gather_small(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(g))
    got = tsg.gather_small_bwd(_t(g), _t(idx), m)
    assert got.shape == (m, d)
    hits = np.bincount(idx.reshape(-1), minlength=m).max()
    scale = float(np.abs(g).max()) * hits
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4 * scale)
    t = _t(table).requires_grad_(True)
    t[_t(idx).long()].backward(_t(g))
    np.testing.assert_allclose(got.numpy(), t.grad.numpy(), rtol=0,
                               atol=1e-6 * scale)


def test_rows_bwd_smem_is_the_table_kernels_layout():
    # one copy of the table a block, padded to float4s
    assert tsg.rows_bwd_smem(512, 11) == 4 * 5632 == 22_528
    assert tsg.rows_bwd_smem(1, 1) == 16
    assert tsg.rows_bwd_smem(3, 3) == 4 * 12
    assert tsg.rows_bwd_smem(5189, 11) <= tsg.SMEM_LIMIT < tsg.rows_bwd_smem(5190, 11)


# (m, d, sites, blocks per SM) -> route, blocks, sites per block, at 132 SMs
PLANS = [
    ((512, 11, 400_000, 2), ("tables", 261, 1536)),    # the LBS shape
    ((5189, 11, 40_000, 1), ("tables", 125, 320)),     # just under the limit
    ((5190, 11, 40_000, 1), ("sorted", 0, 0)),         # just over it
    ((512, 16, 40_000, 2), ("tables", 250, 160)),
    ((64, 33, 40_000, 2), ("tables", 250, 160)),
    ((1, 11, 40_003, 2), ("tables", 251, 160)),
    ((512, 11, 10, 2), ("tables", 1, 32)),             # fewer sites than a batch
    ((100_000, 16, 200_000, 1), ("sorted", 0, 0)),
]


@pytest.mark.parametrize("args,want", PLANS)
def test_rows_bwd_plan_routes_grid_and_scratch(args, want):
    m, d, s, per_sm = args
    asked = []

    def occupancy(smem):
        asked.append(smem)
        return per_sm

    route, blocks, per_block = tsg.rows_bwd_plan(m, d, s, occupancy, 132)
    assert (route, blocks, per_block) == want
    if route == "tables":
        # one wave; every site in exactly one block's range of whole
        # batches, and no range empty
        assert asked == [tsg.rows_bwd_smem(m, d)]
        assert blocks <= per_sm * 132 and per_block % tsg.BATCH == 0
        assert blocks * per_block >= s > (blocks - 1) * per_block
    else:
        assert asked == []           # the occupancy is asked only for tables
