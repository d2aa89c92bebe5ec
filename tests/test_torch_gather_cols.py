"""The LBS column gather (`gather_small_cols`, kernels K2 and K4 through
their plain versions) on tables of any width, and K4's size rule, grid
and scratch (`cols_bwd_plan`, `rows_bwd_smem`), on the CPU.

Above `MAX_M = 1024` columns the reference gathers with a plain float32
one-hot product (`_gather_cols_xla`) and differentiates it with `jax.vjp`;
the port runs the same kernels at any M. Tolerances:
  * forward vs the reference: 1e-6 of max|table| (one product by 1 per
    output on both sides); vs indexing: equal;
  * backward vs `jax.vjp` of the reference: 1e-6 of max|g| times the most
    sites that land on one column (float32 sums of the same terms in
    another order).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dimo_tpu.ops import smallgather as jsg

from dimo_tpu_torch.ops import smallgather as tsg

from torch_parity import one_torch_thread  # noqa: F401

CSRC = Path(tsg.__file__).resolve().parents[1] / "csrc" / "smallgather.cu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(d, m, shape, seed):
    rng = np.random.RandomState(seed)
    table = rng.randn(d, m).astype(np.float32)
    idx = rng.randint(0, m, shape).astype(np.int32)
    g = rng.randn(d, *shape).astype(np.float32)
    return table, idx, g


# M above the reference's MAX_M (its plain one-hot route), around K4's
# shared-memory limit at D = 11 (5,189 fits, 5,190 does not)
LARGE = [(11, 1500, (4, 500)), (11, 6000, (2, 999))]


@pytest.mark.parametrize("d,m,shape", LARGE)
def test_gather_small_cols_large_table_matches_jax_and_indexing(d, m, shape):
    assert m > jsg.MAX_M
    table, idx, _ = _case(d, m, shape, m + d)
    ref = np.asarray(jsg.gather_small_cols(jnp.asarray(table),
                                           jnp.asarray(idx)))
    got = tsg.gather_small_cols(_t(table), _t(idx))
    assert got.shape == (d, *shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-6 * float(np.abs(table).max()))
    np.testing.assert_array_equal(got.numpy(), table[:, idx])


@pytest.mark.parametrize("d,m,shape", LARGE)
def test_gather_small_cols_large_table_vjp_matches_jax(d, m, shape):
    table, idx, g = _case(d, m, shape, m + 2 * d)
    _, vjp = jax.vjp(lambda t: jsg.gather_small_cols(t, jnp.asarray(idx)),
                     jnp.asarray(table))
    (ref,) = vjp(jnp.asarray(g))
    t = _t(table).requires_grad_(True)
    tsg.gather_small_cols(t, _t(idx)).backward(_t(g))
    hits = np.bincount(idx.reshape(-1), minlength=m).max()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6 * float(np.abs(g).max()) * hits)
    assert torch.equal(t.grad, tsg.gather_small_cols_bwd(_t(g), _t(idx), m))


def _cu_int(name):
    """The value of `constexpr int name = <int>;` in csrc/smallgather.cu."""
    found = re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text())
    assert found, name
    return int(found.group(1))


def test_cols_bwd_smem_is_the_table_kernels_layout():
    # one copy of the (D, M) table a block, padded to float4s: the size of
    # K6's (M, D) table, so one function serves both
    assert tsg.rows_bwd_smem(512, 11) == 4 * 5632 == 22_528
    assert tsg.rows_bwd_smem(7, 3) == 4 * 24
    assert tsg.rows_bwd_smem(5189, 11) <= tsg.SMEM_LIMIT < tsg.rows_bwd_smem(5190, 11)
    # the kernel's constants: 1,024-thread blocks, the limit less K6's
    # static index arrays (kBlockWarps x 32 ints), the padded table
    threads = _cu_int("kBlockThreads")
    assert threads == 1024
    assert tsg.SMEM_LIMIT == 232_448 - (threads // 32) * 32 * 4
    assert "(int64_t)m * d + 3) / 4 * 4" in CSRC.read_text()


# (d, m, sites, blocks per SM) -> route, blocks, sites per block, at 132 SMs
PLANS = [
    ((11, 512, 400_000, 2), ("tables", 261, 1536)),    # the LBS shape
    ((11, 5189, 40_000, 1), ("tables", 125, 320)),     # just under the limit
    ((11, 5190, 40_000, 1), ("sorted", 0, 0)),         # just over it
    ((11, 512, 10, 2), ("tables", 1, 32)),             # fewer sites than a batch
    ((11, 512, 40_003, 2), ("tables", 251, 160)),      # S % 4 != 0
    ((11, 1024, 100_000, 2), ("tables", 261, 384)),
    ((1, 1, 5, 2), ("tables", 1, 32)),
    ((16, 100_000, 200_000, 1), ("sorted", 0, 0)),
]


@pytest.mark.parametrize("args,want", PLANS)
def test_cols_bwd_plan_routes_grid_and_scratch(args, want):
    d, m, s, per_sm = args
    asked = []

    def occupancy(smem):
        asked.append(smem)
        return per_sm

    route, blocks, per_block = tsg.cols_bwd_plan(d, m, s, occupancy, 132)
    assert (route, blocks, per_block) == want
    if route == "tables":
        # one wave; every site in exactly one block's range of whole
        # batches, and no range empty; K6's plan for the same table
        assert asked == [tsg.rows_bwd_smem(m, d)]
        assert blocks <= per_sm * 132 and per_block % tsg.BATCH == 0
        assert tsg.rows_bwd_plan(m, d, s, occupancy, 132) == want
        assert blocks * per_block >= s > (blocks - 1) * per_block
        # the scratch: one padded table a block
        assert blocks * tsg.rows_bwd_smem(m, d) // 4 == blocks * (
            (d * m + 3) // 4 * 4)
    else:
        assert asked == []           # the occupancy is asked only for tables
        assert tsg.rows_bwd_smem(m, d) > tsg.SMEM_LIMIT
