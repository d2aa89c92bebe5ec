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
K6 add with atomics, in an order that varies from run to run. Each takes
one of two routes by the table's size alone, by one rule (`rows_bwd_plan`,
which `cols_bwd_plan` calls): shared atomics into a copy
of the table per block, whose partial tables a second pass adds in a
fixed order, or, for a table too large for that, global atomics. The
reference runs column tables above `MAX_M = 1024` through a plain one-hot
product (`_gather_cols_xla`); K2 reads the table from device memory, so
the column pair, too, takes any M.
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
# cotangent, idx, dtable, d, m, s, num_sms, stream (K4's atomic route)
_COLS_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_void_p])
# table/cotangent, idx, out, m, d, s, num_sms, stream (K5, K6's atomic
# route)
_ROWS_ARGTYPES = _COLS_ARGTYPES
# cotangent, idx, part, dtable, m, d, s, blocks, per_block, smem, stream
# (K6's table route; K4's takes d before m)
_TABLES_ARGTYPES = ([ctypes.c_void_p] * 4
                    + [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p])
# The table routes of K6 and K4 (csrc/smallgather.cu, above K6 and K4):
# one copy of the table, padded to float4s, in each block's shared memory;
# the table may take SMEM_LIMIT bytes of dynamic shared memory, the 227 KB
# of an H100 block less K6's 4 KB of static index arrays (the kernels'
# kMaxSmem; a launch refuses a size that differs from its layout). A
# block's range of sites is whole batches of BATCH, one warp's coalesced
# load.
SMEM_LIMIT = 232_448 - 4_096
BATCH = 32
# sites per one-hot product in the plain backward, and the most elements
# one such product's one-hot may hold (they bound its memory)
_PLAIN_CHUNK = 1 << 16
_PLAIN_ONEHOT = 1 << 26


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


def gather_small_cols_bwd_plain(g: torch.Tensor, idx: torch.Tensor,
                                m: int) -> torch.Tensor:
    """Plain version of kernel K4: g (D, ...) cotangent at idx (...) ->
    (D, m) float32, dtable[d, j] = sum of g[d, s] over the sites with
    idx[s] == j; indices outside [0, m) add nothing. A one-hot product in
    chunks of sites, the reference kernel's formula in float32."""
    d = g.shape[0]
    flat = idx.reshape(-1).long()
    g2 = g.reshape(d, -1).float()
    cols = torch.arange(m, device=g.device)
    out = torch.zeros((d, m), dtype=torch.float32, device=g.device)
    chunk = max(1, min(_PLAIN_CHUNK, _PLAIN_ONEHOT // max(m, 1)))
    for i in range(0, flat.shape[0], chunk):
        oh = (flat[i:i + chunk, None] == cols[None, :]).float()
        out = out + g2[:, i:i + chunk] @ oh
    return out


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
    stream = torch.cuda.current_stream(dev).cuda_stream
    route, blocks, per_block = cols_bwd_plan(
        d, m, s, lambda smem: cols_occupancy(dev, smem)[0], _num_sms(dev))
    if route == "tables":
        part = torch.empty((blocks, (m * d + 3) // 4 * 4),
                           dtype=torch.float32, device=dev)
        out = torch.empty((d, m), dtype=torch.float32, device=dev)
        fn = build.function("smallgather", "gather_small_cols_bwd_tables",
                            _TABLES_ARGTYPES)
        build.check(fn(g2.data_ptr(), flat.data_ptr(), part.data_ptr(),
                       out.data_ptr(), d, m, s, blocks, per_block,
                       rows_bwd_smem(m, d), stream),
                    "gather_small_cols_bwd_tables")
    else:
        out = torch.zeros((d, m), dtype=torch.float32, device=dev)
        fn = build.function("smallgather", "gather_small_cols_bwd_atomics",
                            _COLS_ARGTYPES)
        build.check(fn(g2.data_ptr(), flat.data_ptr(), out.data_ptr(), d, m,
                       s, _num_sms(dev), stream),
                    "gather_small_cols_bwd_atomics")
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


def gather_small_bwd_plain(g: torch.Tensor, idx: torch.Tensor,
                           m: int) -> torch.Tensor:
    """Plain version of kernel K6: g (..., D) cotangent at idx (...) ->
    (m, D) float32, dtable[j, :] = sum of g[s, :] over the sites with
    idx[s] == j; indices outside [0, m) add nothing. A one-hot product in
    chunks of sites, the reference kernel's formula in float32."""
    d = g.shape[-1]
    flat = idx.reshape(-1).long()
    g2 = g.reshape(-1, d).float()
    cols = torch.arange(m, device=g.device)
    out = torch.zeros((m, d), dtype=torch.float32, device=g.device)
    chunk = max(1, min(_PLAIN_CHUNK, _PLAIN_ONEHOT // max(m, 1)))
    for i in range(0, flat.shape[0], chunk):
        oh = (flat[i:i + chunk, None] == cols[None, :]).float()
        out = out + oh.T @ g2[i:i + chunk]
    return out


def rows_bwd_smem(m: int, d: int) -> int:
    """Bytes of shared memory a block of K6's table route needs for an
    (m, d) table, and K4's for a (d, m) one: m x d floats padded to
    float4s."""
    return 4 * ((m * d + 3) // 4 * 4)


def rows_bwd_plan(m: int, d: int, s: int, blocks_per_sm, num_sms: int
                  ) -> tuple[str, int, int]:
    """K6's route for an (m, d) table and s sites: ("tables", blocks,
    sites per block) when the table fits a block's shared memory, else
    ("atomics", 0, 0). This is the one place of the size rule, K4's too
    (`cols_bwd_plan`). The table route's grid is one wave,
    `blocks_per_sm(smem)` (the occupancy API at `rows_bwd_smem` bytes;
    called only for that route) times `num_sms`, capped by the BATCH-site
    batches; each block takes a contiguous range of whole batches, no
    block's range is empty, and the scratch holds blocks x (m x d rounded
    up to a multiple of 4) floats."""
    smem = rows_bwd_smem(m, d)
    if smem > SMEM_LIMIT:
        return "atomics", 0, 0
    batches = -(-s // BATCH)
    blocks = max(1, min(blocks_per_sm(smem) * num_sms, batches))
    per = -(-batches // blocks)               # batches a block
    return "tables", -(-batches // per) if per else 1, per * BATCH


def cols_bwd_plan(d: int, m: int, s: int, blocks_per_sm, num_sms: int
                  ) -> tuple[str, int, int]:
    """K4's route, grid and scratch for a (d, m) table and s sites: K6's
    for the (m, d) table of the same size (`rows_bwd_plan`)."""
    return rows_bwd_plan(m, d, s, blocks_per_sm, num_sms)


@functools.lru_cache(maxsize=None)
def rows_occupancy(device: torch.device, smem: int) -> tuple[int, int, int]:
    """Resident blocks per SM of K5, of K6's table-route kernel at `smem`
    bytes of shared memory, and of K6's second pass (the CUDA occupancy
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
    """Resident blocks per SM of K4's table-route kernel at `smem` bytes
    of shared memory and of its second pass (the CUDA occupancy API on the
    kernels as built)."""
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    route, blocks, per_block = rows_bwd_plan(
        m, d, s, lambda smem: rows_occupancy(dev, smem)[1], _num_sms(dev))
    if route == "tables":
        part = torch.empty((blocks, (m * d + 3) // 4 * 4),
                           dtype=torch.float32, device=dev)
        out = torch.empty((m, d), dtype=torch.float32, device=dev)
        fn = build.function("smallgather", "gather_small_rows_bwd_tables",
                            _TABLES_ARGTYPES)
        build.check(fn(g2.data_ptr(), flat.data_ptr(), part.data_ptr(),
                       out.data_ptr(), m, d, s, blocks, per_block,
                       rows_bwd_smem(m, d), stream),
                    "gather_small_rows_bwd_tables")
    else:
        out = torch.zeros((m, d), dtype=torch.float32, device=dev)
        fn = build.function("smallgather", "gather_small_rows_bwd_atomics",
                            _ROWS_ARGTYPES)
        build.check(fn(g2.data_ptr(), flat.data_ptr(), out.data_ptr(), m, d,
                       s, _num_sms(dev), stream),
                    "gather_small_rows_bwd_atomics")
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
