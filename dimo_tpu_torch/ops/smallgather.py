"""Gathers from a SMALL table: the column layout, kernels K2 (forward) and
K4 (backward), and the row layout, kernels K5 and K6.

Counterpart of `dimo_tpu/ops/smallgather.py`: `gather_small_cols` with its
custom VJP (`_gc_fwd`/`_gc_bwd`), and `gather_small` with its
(`_gs_fwd`/`_gs_bwd`).
The LBS blend (`models/deform.py`) gathers the fused (11, M) control-point
table `[radius | c_xyz | d_xyz | d_rot]` at (K, N) neighbour indices and
reads the result component-wise as (11, K, N).

The gather is differentiable in the table: its backward adds the
(D, K, N) cotangent into the (D, M) table, dtable[d, idx[s]] += g[d, s].

`gather_small` is the same function in row layout: table (M, D), indices
(...) -> (..., D), and its backward dtable[idx[s], :] += g[s, :]. The
reference runs tables above `MAX_M = 1024` rows through a plain one-hot
product (`gather_small_xla`); here one pair of kernels takes any M: the
table is read from, and added into, device memory.

On a CUDA tensor the wrappers launch the hand-written kernels in
`csrc/smallgather.cu` (K2 and K5 gather, K4 and K6 scatter-add); on a CPU
tensor they run the `_plain` functions beside them. There is no other
route: an unsupported input raises.

Numerics: the TPU kernels gather and scatter `hi + lo` (a bf16 split of
each value, ~2^-17 relative error); the port's are exact float32, so the
port is compared with the reference at 2e-5 of the values' scale. K4 and
K6 add without atomics, each entry in a fixed order (`csrc/smallgather.cu`
says which), so a run on the card gives the same bits every time, as the
reference's grid, which the TPU runs in order, does. Each takes one of two
routes by the table's size alone, by one rule (`rows_bwd_plan`, which
`cols_bwd_plan` calls): a copy of the table per block in shared memory,
each chunk of sites sorted by index there and each run of an index summed
by one thread, the blocks' partial tables then added in a fixed order, on a
grid set by the shape alone, so the same inputs give the same bits on any
card and on the CPU; or, for a table too large for that, a stable sort of
the sites by index and a segment sum of each run (`scatter_sorted`). The
plain versions sum in the same orders, so each kernel equals its plain
version bit for bit. The strip path's row scatter
(`ops/rasterizer/gather.py`) shares `CHUNK` and `_ordered_sums` with this
module and has its own route. The reference runs column
tables above `MAX_M = 1024` through a plain one-hot product
(`_gather_cols_xla`); K2 reads the table from device memory, so the column
pair, too, takes any M.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from dimo_tpu_torch import build

# launches of the CUDA kernels since the last reset, K2, K4, K5 and K6
# (chip_smoke reads them)
launches = 0
bwd_launches = 0
rows_launches = 0
rows_bwd_launches = 0
# table, idx, out, d, m, s, stream (K2: its grid follows s alone)
_GATHER_COLS_ARGTYPES = ([ctypes.c_void_p] * 3
                         + [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_void_p])
# table, idx, out, m, d, s, num_sms, stream (K5)
_ROWS_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_void_p])
# cotangent, sorted keys, their sites, head, tail, dtable, m, d, s, stream
# (the sorted route; K4's takes d before m)
_SORTED_ARGTYPES = ([ctypes.c_void_p] * 6
                    + [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_void_p])
# cotangent, idx, part, dtable, m, d, s, blocks, per_block, smem, stream
# (K6's table route; K4's takes d before m)
_TABLES_ARGTYPES = ([ctypes.c_void_p] * 4
                    + [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p])
# The table route of K6 and K4 (csrc/smallgather.cu, above K6): one copy
# of the table, padded to float4s, in each block's shared memory; the table
# may take SMEM_LIMIT bytes of dynamic shared memory, the 227 KB of an H100
# block less the 4 KB of a chunk's static key array (the kernels'
# kMaxSmem; a launch refuses a size that differs from its layout). A
# block's range of sites is whole batches of BATCH, one warp's coalesced
# load, taken CHUNK sites at a time (kChunk; the row scatter cuts its
# slots into chunks of as many). The sorted route's first pass cuts the
# sorted sites into tiles of SEG_TILE (kSegTile).
SMEM_LIMIT = 232_448 - 4_096
BATCH = 32
# The table route's most blocks: the grid an H100 SXM runs at the LBS
# shape, one 1,024-thread block on each of its 132 SMs. A constant, so
# that the order of K4's and K6's sums is the same on any card and on the
# CPU (rows_bwd_plan)
MAX_BLOCKS = 132
CHUNK = 1024
SEG_TILE = 128


def gather_small_cols_plain(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: table_t (D, M), idx (...) -> (D, ...) float32, with
    zeros for indices outside [0, M)."""
    d, m = table_t.shape
    flat = idx.reshape(-1).long()
    ok = (flat >= 0) & (flat < m)
    out = table_t.float()[:, flat.clamp(0, max(m - 1, 0))]
    out = torch.where(ok[None, :], out, torch.zeros((), dtype=out.dtype,
                                                    device=out.device))
    return out.reshape(d, *idx.shape)


def gather_small_cols_bwd_plain(g: torch.Tensor, idx: torch.Tensor, m: int,
                                plan: tuple[int, int] | None = None
                                ) -> torch.Tensor:
    """Plain version of kernel K4: g (D, ...) cotangent at idx (...) ->
    (D, m) float32, dtable[d, j] = sum of g[d, s] over the sites with
    idx[s] == j; indices outside [0, m) add nothing. K6's plain version on
    the transposed layout: the same sums in the same order."""
    d = g.shape[0]
    return gather_small_bwd_plain(g.reshape(d, -1).T, idx.reshape(-1), m,
                                  plan).T.contiguous()


@functools.lru_cache(maxsize=None)
def _num_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _gather_cols_cuda(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K2's launch, cut to what it must do: it runs once per render."""
    global launches
    if table_t.dtype != torch.float32:
        raise TypeError(f"table must be float32, got {table_t.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    dev = table_t.device
    if idx.device != dev:
        raise ValueError("table and idx must be on the same device")
    d, m = table_t.shape
    if not table_t.is_contiguous():
        table_t = table_t.contiguous()
    if not idx.is_contiguous():
        idx = idx.contiguous()
    out = torch.empty((d, *idx.shape), dtype=torch.float32, device=dev)
    s = idx.numel()
    if s > 0:
        fn = build.function("smallgather", "gather_small_cols_fwd",
                            _GATHER_COLS_ARGTYPES)
        build.check(fn(table_t.data_ptr(), idx.data_ptr(), out.data_ptr(), d,
                       m, s, torch.cuda.current_stream(dev).cuda_stream),
                    "gather_small_cols")
        launches += 1
    return out


def _scatter_cols_cuda(g: torch.Tensor, idx: torch.Tensor, m: int) -> torch.Tensor:
    global bwd_launches
    d = g.shape[0]
    flat = idx.reshape(-1).contiguous()
    s = flat.shape[0]
    g2 = g.reshape(d, s).contiguous()
    _rows_check("gather_small_cols_bwd", g2, flat, m, d)
    dev = g.device
    if g2.numel() == 0 or m == 0:
        return torch.zeros((d, m), dtype=torch.float32, device=dev)
    route, blocks, per_block = cols_bwd_plan(d, m, s)
    if route == "tables":
        out = _scatter_tables(g2, flat, m, d, blocks, per_block, cols=True)
    else:
        out = scatter_sorted(g2, flat, m, d, cols=True)
    bwd_launches += 1
    return out


def gather_small_cols_bwd(g: torch.Tensor, idx: torch.Tensor, m: int) -> torch.Tensor:
    """Transpose of `gather_small_cols`: (D, ...) cotangent -> (D, m)
    table grad. Kernel K4 on the card, the plain version on the CPU."""
    if g.device.type == "cuda":
        return _scatter_cols_cuda(g, idx, m)
    if g.device.type == "cpu":
        return gather_small_cols_bwd_plain(g, idx, m)
    raise ValueError(f"unsupported device {g.device}")


def _gather_fwd(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table_t.device.type == "cuda":
        return _gather_cols_cuda(table_t, idx)
    if table_t.device.type == "cpu":
        return gather_small_cols_plain(table_t, idx)
    raise ValueError(f"unsupported device {table_t.device}")


class _GatherCols(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_t, idx):
        ctx.save_for_backward(idx)
        ctx.m = table_t.shape[1]
        return _gather_fwd(table_t, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_small_cols_bwd(g.contiguous(), idx, ctx.m), None


def gather_small_cols(table_t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table_t (D, M) with small M; idx (...) int -> (D, ...) float32.
    Indices outside [0, M) read zeros. Differentiable in table_t."""
    if torch.is_grad_enabled() and table_t.requires_grad:
        return _GatherCols.apply(table_t, idx)
    return _gather_fwd(table_t, idx)


# ---------------------------------------------------------------------------
# Row layout: out (S, D) from table (M, D). Kernels K5 and K6.
# ---------------------------------------------------------------------------


def gather_small_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K5: table (M, D), idx (...) -> (..., D)
    float32, with zero rows for indices outside [0, M)."""
    m, d = table.shape
    flat = idx.reshape(-1).long()
    ok = (flat >= 0) & (flat < m)
    out = table.float()[flat.clamp(0, max(m - 1, 0))]
    out = torch.where(ok[:, None], out, torch.zeros((), dtype=out.dtype,
                                                    device=out.device))
    return out.reshape(*idx.shape, d)


def _ordered_sums(vals: torch.Tensor, key: torch.Tensor):
    """vals (n, D), key (n,) int64 -> (the distinct keys ascending (G,),
    (G, D) sums): each key's rows of vals added one by one in row order,
    from 0, as a kernel's thread adds them (one float32 rounding an add)."""
    order = torch.sort(key, stable=True).indices
    ks = key[order]
    n = ks.shape[0]
    new = torch.ones(n, dtype=torch.bool, device=key.device)
    new[1:] = ks[1:] != ks[:-1]
    gid = torch.cumsum(new, 0) - 1
    starts = torch.nonzero(new)[:, 0]
    rank = torch.arange(n, device=key.device) - starts[gid]
    acc = torch.zeros((starts.shape[0], vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    by_rank = torch.sort(rank, stable=True).indices
    lo = 0
    for count in torch.bincount(rank).tolist():
        at = by_rank[lo:lo + count]           # one row of each key at most
        acc[gid[at]] = acc[gid[at]] + vals[order[at]]
        lo += count
    return ks[starts], acc


def _tables_plain(vals: torch.Tensor, flat: torch.Tensor, m: int,
                  blocks: int, per_block: int) -> torch.Tensor:
    """The table route's sums, in its order (csrc/smallgather.cu, above
    K6): vals (S, D) -> (m, D)."""
    s, d = vals.shape
    dev = vals.device
    site = torch.arange(s, device=dev)
    block = site // per_block
    chunks = -(-per_block // CHUNK)               # chunks a block
    chunk = block * chunks + (site - block * per_block) // CHUNK
    ok = (flat >= 0) & (flat < m)
    keys, sums = _ordered_sums(vals[ok], chunk[ok] * m + flat[ok])
    run_chunk, run_j = keys // m, keys % m
    tables = torch.zeros((blocks, m, d), dtype=torch.float32, device=dev)
    for k in range(chunks):                        # a block's chunks in order
        at = run_chunk % chunks == k
        b, j = run_chunk[at] // chunks, run_j[at]
        tables[b, j] = tables[b, j] + sums[at]
    # combine_tables_kernel: warp w adds blocks w, w + 32, ...; then warp
    # order
    red = torch.zeros((32, m, d), dtype=torch.float32, device=dev)
    for b0 in range(0, blocks, 32):
        n = min(32, blocks - b0)
        red[:n] = red[:n] + tables[b0:b0 + n]
    out = red[0]
    for w in range(1, 32):
        out = out + red[w]
    return out


def scatter_sorted_plain(vals: torch.Tensor, flat: torch.Tensor,
                         m: int) -> torch.Tensor:
    """Plain version of the sorted route (`scatter_sorted`): its sums in its
    order (csrc/smallgather.cu, above K6), vals (S, D) at flat (S,) int64
    -> (m, D), of vals' dtype."""
    s, d = vals.shape
    dev = vals.device
    out = torch.zeros((m, d), dtype=vals.dtype, device=dev)
    if s == 0:
        return out
    keys, order = torch.sort(flat, stable=True)
    tile = torch.arange(s, device=dev) // SEG_TILE
    new = torch.ones(s, dtype=torch.bool, device=dev)
    new[1:] = (keys[1:] != keys[:-1]) | (tile[1:] != tile[:-1])
    _, pieces = _ordered_sums(vals[order], torch.cumsum(new, 0) - 1)
    piece_key = keys[new]
    ok = (piece_key >= 0) & (piece_key < m)
    runs, sums = _ordered_sums(pieces[ok], piece_key[ok])
    out[runs] = sums
    return out


def gather_small_bwd_plain(g: torch.Tensor, idx: torch.Tensor, m: int,
                           plan: tuple[int, int] | None = None
                           ) -> torch.Tensor:
    """Plain version of kernel K6: g (..., D) cotangent at idx (...) ->
    (m, D) float32, dtable[j, :] = sum of g[s, :] over the sites with
    idx[s] == j; indices outside [0, m) add nothing. The kernel's sums in
    its order: a table that fits shared memory by the table route's, on
    the grid of `rows_bwd_plan` (the card's) unless `plan` = (blocks,
    sites a block) names another, a larger one by the sorted route's."""
    d = g.shape[-1]
    flat = idx.reshape(-1).long()
    vals = g.reshape(-1, d).float()
    if rows_bwd_smem(m, d) > SMEM_LIMIT:
        return scatter_sorted_plain(vals, flat, m)
    blocks, per_block = plan or rows_bwd_plan(m, d, flat.shape[0])[1:]
    return _tables_plain(vals, flat, m, blocks, per_block)


def rows_bwd_smem(m: int, d: int) -> int:
    """Bytes of shared memory a block of K6's table route needs for an
    (m, d) table, and K4's for a (d, m) one: m x d floats padded to
    float4s."""
    return 4 * ((m * d + 3) // 4 * 4)


def rows_bwd_plan(m: int, d: int, s: int) -> tuple[str, int, int]:
    """K6's route for an (m, d) table and s sites: ("tables", blocks,
    sites per block) when the table fits a block's shared memory, else
    ("sorted", 0, 0). This is the one place of the size rule, K4's too
    (`cols_bwd_plan`). The table route's grid follows (m, d, s) alone, so
    its order of summation does too (no SM count or occupancy reaches
    it): at most MAX_BLOCKS blocks, capped by the BATCH-site batches; each
    block takes a contiguous range of whole batches, no block's range is
    empty, and the scratch holds blocks x (m x d rounded up to a multiple
    of 4) floats."""
    smem = rows_bwd_smem(m, d)
    if smem > SMEM_LIMIT:
        return "sorted", 0, 0
    batches = max(1, -(-s // BATCH))
    per = -(-batches // min(MAX_BLOCKS, batches))   # batches a block
    return "tables", -(-batches // per), per * BATCH


def cols_bwd_plan(d: int, m: int, s: int) -> tuple[str, int, int]:
    """K4's route, grid and scratch for a (d, m) table and s sites: K6's
    for the (m, d) table of the same size (`rows_bwd_plan`)."""
    return rows_bwd_plan(m, d, s)


@functools.lru_cache(maxsize=None)
def rows_occupancy(device: torch.device, smem: int) -> tuple[int, int, int]:
    """Resident blocks per SM of K5, of the table route's kernel at `smem`
    bytes of shared memory, and of its second pass (the CUDA occupancy
    API on the kernels as built)."""
    blocks = (ctypes.c_int * 3)()
    fn = build.function("smallgather", "gather_small_rows_occupancy",
                        [ctypes.c_int64, ctypes.c_void_p])
    with torch.cuda.device(device):
        build.check(fn(smem, ctypes.addressof(blocks)),
                    "gather_small_rows_occupancy")
    return tuple(blocks)


@functools.lru_cache(maxsize=None)
def cols_occupancy(device: torch.device, smem: int) -> tuple[int, int]:
    """Resident blocks per SM of the table route's kernel (K4's and K6's)
    at `smem` bytes of shared memory and of its second pass (the CUDA
    occupancy API on the kernels as built)."""
    blocks = (ctypes.c_int * 2)()
    fn = build.function("smallgather", "gather_small_cols_occupancy",
                        [ctypes.c_int64, ctypes.c_void_p])
    with torch.cuda.device(device):
        build.check(fn(smem, ctypes.addressof(blocks)),
                    "gather_small_cols_occupancy")
    return tuple(blocks)


def _rows_check(name: str, a: torch.Tensor, flat: torch.Tensor, m: int,
                d: int) -> None:
    if a.dtype != torch.float32:
        raise TypeError(f"{name}: values must be float32, got {a.dtype}")
    if flat.dtype != torch.int32:
        raise TypeError(f"{name}: idx must be int32, got {flat.dtype}")
    if flat.device != a.device:
        raise ValueError(f"{name}: values and idx must be on the same device")
    if m >= 1 << 31 or d >= 1 << 31:
        raise ValueError(f"{name}: table ({m}, {d}) is too large")


def _gather_rows_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    global rows_launches
    m, d = table.shape
    flat = idx.reshape(-1).contiguous()
    _rows_check("gather_small_rows_fwd", table, flat, m, d)
    out = torch.empty((flat.shape[0], d), dtype=torch.float32,
                      device=table.device)
    if out.numel() > 0:
        fn = build.function("smallgather", "gather_small_rows_fwd",
                            _ROWS_ARGTYPES)
        stream = torch.cuda.current_stream(table.device).cuda_stream
        build.check(fn(table.contiguous().data_ptr(), flat.data_ptr(),
                       out.data_ptr(), m, d, flat.shape[0],
                       _num_sms(table.device), stream),
                    "gather_small_rows_fwd")
        rows_launches += 1
    return out.reshape(*idx.shape, d)


def _scatter_tables(g2: torch.Tensor, flat: torch.Tensor, m: int, d: int,
                    blocks: int, per_block: int, cols: bool) -> torch.Tensor:
    """The table route of K6 (g2 (s, d) -> (m, d)) or, `cols`, K4 (g2 (d,
    s) -> (d, m))."""
    dev = g2.device
    part = torch.empty((blocks, (m * d + 3) // 4 * 4), dtype=torch.float32,
                       device=dev)
    out = torch.empty((d, m) if cols else (m, d), dtype=torch.float32,
                      device=dev)
    name = f"gather_small_{'cols' if cols else 'rows'}_bwd_tables"
    fn = build.function("smallgather", name, _TABLES_ARGTYPES)
    build.check(fn(g2.data_ptr(), flat.data_ptr(), part.data_ptr(),
                   out.data_ptr(), *((d, m) if cols else (m, d)),
                   flat.shape[0], blocks, per_block, rows_bwd_smem(m, d),
                   torch.cuda.current_stream(dev).cuda_stream), name)
    return out


def scatter_sorted(g2: torch.Tensor, flat: torch.Tensor, m: int, d: int,
                   cols: bool = False) -> torch.Tensor:
    """The sorted route on the card: `torch.sort` (stable) of the int32
    indices, then the two passes of the segment sum. g2 (s, d) -> (m, d),
    or, `cols`, g2 (d, s) -> (d, m). Counts no launch (its callers do)."""
    dev = g2.device
    s = flat.shape[0]
    out = torch.zeros((d, m) if cols else (m, d), dtype=torch.float32,
                      device=dev)
    if s == 0 or m == 0 or d == 0:
        return out
    keys, order = torch.sort(flat, stable=True)
    tiles = -(-s // SEG_TILE)
    head = torch.empty((tiles, d), dtype=torch.float32, device=dev)
    tail = torch.empty((tiles, d), dtype=torch.float32, device=dev)
    name = f"gather_small_{'cols' if cols else 'rows'}_bwd_sorted"
    fn = build.function("smallgather", name, _SORTED_ARGTYPES)
    build.check(fn(g2.data_ptr(), keys.data_ptr(), order.data_ptr(),
                   head.data_ptr(), tail.data_ptr(), out.data_ptr(),
                   *((d, m) if cols else (m, d)), s,
                   torch.cuda.current_stream(dev).cuda_stream), name)
    return out


def _scatter_rows_cuda(g: torch.Tensor, idx: torch.Tensor, m: int) -> torch.Tensor:
    global rows_bwd_launches
    d = g.shape[-1]
    flat = idx.reshape(-1).contiguous()
    s = flat.shape[0]
    g2 = g.reshape(s, d).contiguous()
    _rows_check("gather_small_rows_bwd", g2, flat, m, d)
    dev = g.device
    if g2.numel() == 0 or m == 0:
        return torch.zeros((m, d), dtype=torch.float32, device=dev)
    route, blocks, per_block = rows_bwd_plan(m, d, s)
    if route == "tables":
        out = _scatter_tables(g2, flat, m, d, blocks, per_block, cols=False)
    else:
        out = scatter_sorted(g2, flat, m, d)
    rows_bwd_launches += 1
    return out


def gather_small_bwd(g: torch.Tensor, idx: torch.Tensor, m: int) -> torch.Tensor:
    """Transpose of `gather_small`: (..., D) cotangent -> (m, D) table
    grad. Kernel K6 on the card, the plain version on the CPU."""
    if g.device.type == "cuda":
        return _scatter_rows_cuda(g, idx, m)
    if g.device.type == "cpu":
        return gather_small_bwd_plain(g, idx, m)
    raise ValueError(f"unsupported device {g.device}")


def _gather_rows_fwd(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if table.dim() != 2:
        raise ValueError(f"table must be (M, D), got {tuple(table.shape)}")
    if table.device.type == "cuda":
        return _gather_rows_cuda(table, idx)
    if table.device.type == "cpu":
        return gather_small_plain(table, idx)
    raise ValueError(f"unsupported device {table.device}")


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.m = table.shape[0]
        return _gather_rows_fwd(table, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return gather_small_bwd(g.contiguous(), idx, ctx.m), None


def gather_small(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (M, D), any M; idx (...) int -> (..., D) float32. Indices
    outside [0, M) read zero rows. Differentiable in table."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _GatherRows.apply(table, idx)
    return _gather_rows_fwd(table, idx)
