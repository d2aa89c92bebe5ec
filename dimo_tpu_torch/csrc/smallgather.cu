// LBS column gather (kernel K2): out[d, s] = table[d, idx[s]] for a small
// (D, M) table, and its transpose (kernel K4, described above its kernel):
// dtable[d, idx[s]] += g[d, s]; the same pair in row layout, K5
// (out[s, :] = table[idx[s], :]) and K6 (its transpose); and the strip
// path's row scatter (above run_sums_kernel). Each is described above its
// kernel.
//
// K2 replaces dimo_tpu/ops/smallgather.py:_fwd_kernel_cols (called through
// _fwd_call_cols / gather_small_cols), which the TPU ran as a one-hot
// bf16 hi+lo matmul because XLA's gather serialises rows there.
//
// What bounds it on the H100: bytes. At the flagship (D=11, M=512,
// S=K*N=400k) the kernel reads 1.6 MB of indices and writes 17.6 MB of
// output, against a 22.5 KB table: 5.74 us at 3.35 TB/s. There is no
// arithmetic to speak of.
//
// Design: each thread owns FOUR consecutive sites: one 16-byte int4 index
// load, the table reads of four rows issued before their stores, and each
// of the D output rows written as one 16-byte float4 streaming store
// (__stcs), so a warp moves 512 bytes per store instruction. The table is
// read through the read-only path (__ldg) and stays in L1 after first
// touch: no shared-memory copy, no barrier. The grid is ceil(S / 4 / 256)
// blocks, 391 at the flagship; at 64 registers a thread an SM holds four
// blocks, so the card holds them all at once: one wave. The vector path
// needs S % 4 == 0 and 16-byte aligned idx and out; any other input (a
// view at a storage offset, S % 4 != 0) takes the scalar path of the same
// kernel, sites strided by the grid's thread count so every warp store
// stays coalesced.
//
// Measured in a CUDA graph on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py,
// PERF.md, Findings), in turns: 7.29-7.30 us against 9.69-9.70 for the design
// it replaced (a grid of 4 blocks per SM, each staging the table in shared
// memory behind a barrier, then one site per thread per step with one
// dependent index load and D scalar stores); a fill_ of the output alone
// takes 5.50-5.53 us. Holding all D rows in registers before the stores
// (119 registers, 1.5 waves) took 9.2-9.3 us; staging the table in shared
// memory on top of this design took 2-6% less, not taken: it would bound M
// and bring back the attribute call for large tables.
//
// Exact float32 (no bf16 split); an index outside [0, M) reads zeros, as
// the TPU kernel's one-hot does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSites = 4;       // consecutive sites per thread (K2)
constexpr int kRowChunk = 4;    // table rows read before their stores (K2)

__global__ void __launch_bounds__(kThreads)
gather_cols_kernel(const float* __restrict__ table,
                   const int32_t* __restrict__ idx, float* __restrict__ out,
                   int d, int m, int64_t s, bool vec) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (vec) {
    const int64_t groups = s / kSites;           // float4s per output row
    if (g >= groups) return;
    const int4 j = __ldg(reinterpret_cast<const int4*>(idx) + g);
    const bool ok0 = (unsigned)j.x < (unsigned)m;
    const bool ok1 = (unsigned)j.y < (unsigned)m;
    const bool ok2 = (unsigned)j.z < (unsigned)m;
    const bool ok3 = (unsigned)j.w < (unsigned)m;
    float4* o = reinterpret_cast<float4*>(out) + g;
    for (int r0 = 0; r0 < d; r0 += kRowChunk) {
      float4 v[kRowChunk];
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i) {
        if (r0 + i < d) {
          const float* t = table + (int64_t)(r0 + i) * m;
          v[i].x = ok0 ? __ldg(t + j.x) : 0.0f;
          v[i].y = ok1 ? __ldg(t + j.y) : 0.0f;
          v[i].z = ok2 ? __ldg(t + j.z) : 0.0f;
          v[i].w = ok3 ? __ldg(t + j.w) : 0.0f;
        }
      }
#pragma unroll
      for (int i = 0; i < kRowChunk; ++i)
        if (r0 + i < d) __stcs(o + (int64_t)(r0 + i) * groups, v[i]);
    }
    return;
  }
  const int64_t threads = (int64_t)gridDim.x * kThreads;
  for (int64_t site = g; site < s; site += threads) {
    const int j = __ldg(idx + site);
    const bool ok = (unsigned)j < (unsigned)m;
    for (int r = 0; r < d; ++r)
      __stcs(out + r * s + site, ok ? __ldg(table + (int64_t)r * m + j) : 0.0f);
  }
}


}  // namespace

// table: (d, m) float32; idx: (s,) int32; out: (d, s) float32.
// Returns cudaError_t.
extern "C" int gather_small_cols_fwd(const float* table, const int32_t* idx,
                                     float* out, int d, int m, int64_t s,
                                     cudaStream_t stream) {
  if (s <= 0) return 0;
  const bool vec = s % kSites == 0 &&
                   (reinterpret_cast<uintptr_t>(idx) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int64_t blocks = (s + kSites * kThreads - 1) / (kSites * kThreads);
  gather_cols_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      table, idx, out, d, m, s, vec);
  return (int)cudaGetLastError();
}

namespace {

// K5: the same gather in ROW layout, out[s, :] = table[idx[s], :] for an
// (M, D) table, (S, D) out.
//
// Replaces dimo_tpu/ops/smallgather.py:_fwd_kernel (called through
// _fwd_call / gather_small), a one-hot bf16 hi+lo matmul on the TPU.
//
// What bounds it on the H100: bytes, as K2: at the LBS shape (M=512, D=11,
// S=400k) 1.6 MB of indices in and 17.6 MB of rows out, 5.74 us at
// 3.35 TB/s.
//
// Design: a warp owns a chunk of 128 consecutive rows, four a lane: each
// lane loads its four indices with one 16-byte int4 into a 512-byte
// per-warp shared array. The chunk's output is 32*D contiguous float4s; on
// store step k lane l writes float4 number 32k + l, so every store
// instruction writes 512 contiguous bytes (__stcs). Each lane finds the
// row and column of its float4's first element once, from one 32-bit
// division, and steps them by 128 elements a store (128 / D rows, 128 % D
// columns) and by one within the float4: no division in the loop. The
// table is read through __ldg and stays in L1 at any M. The grid is one
// wave: the occupancy API's resident blocks per SM times the SMs, capped
// by the chunks; warps walk chunks grid-stride. The vector path needs
// S % 4 == 0 and 16-byte aligned idx and out; any other input takes the
// scalar path of the same kernel: chunks of 32 rows, one a lane, scalar
// loads and 128-byte stores.
//
// Measured in a CUDA graph on NVIDIA H100 80GB HBM3, 700.00 W
// (chip_smoke.py, PERF.md, Findings), in turns, at the LBS shape: 7.19-7.20
// us (40 registers, 6 blocks an SM) against 14.33-14.34 for the design it
// replaced (threads on the flattened S*D output, a 64-bit division and an
// index load per element) and 13.1 for index_select. Designs that lost,
// in the same run: four rows a thread with its D float4s contiguous,
// lanes 16*D bytes apart, 20.88-20.89 us; the warp's 128 rows staged in
// shared memory, then stored as float4s, 13.86-13.87 us.
//
// Exact float32; an index outside [0, M) reads zeros.
constexpr int kWarps = kThreads / 32;
constexpr int kLaneRows = 4;                   // K5 vector path: rows a lane
constexpr int kChunkRows = 32 * kLaneRows;     // K5: rows a warp chunk

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// One warp's chunk of K5: rows [row0, row0 + rows) of out, R rows a lane
// (rows is a multiple of R).
template <int R>
__device__ __forceinline__ void gather_rows_chunk(
    const float* __restrict__ table, const int32_t* __restrict__ idx,
    float* __restrict__ out, int* wi, int m, int d, int64_t row0, int rows,
    int lane) {
  if (R * lane < rows) {
    if constexpr (R == 4)
      reinterpret_cast<int4*>(wi)[lane] =
          __ldg(reinterpret_cast<const int4*>(idx + row0) + lane);
    else
      wi[lane] = __ldg(idx + row0 + lane);
  }
  __syncwarp();
  // (row, col) of the lane's first element, and its step per store
  const int dr = 32 * R / d, dc = 32 * R - dr * d;
  int r = R * lane / d;
  int c = R * lane - r * d;
  const int64_t n = (int64_t)rows * d / R;     // vectors in the chunk
  float* o = out + row0 * d;
  for (int64_t f = lane; f < n; f += 32) {
    float v[R];
    int rr = r, cc = c;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int j = wi[rr];
      v[i] = (unsigned)j < (unsigned)m ? __ldg(table + (int64_t)j * d + cc)
                                       : 0.0f;
      if (++cc == d) {
        cc = 0;
        ++rr;
      }
    }
    if constexpr (R == 4)
      __stcs(reinterpret_cast<float4*>(o) + f,
             make_float4(v[0], v[1], v[2], v[3]));
    else
      __stcs(o + f, v[0]);
    r += dr;
    c += dc;
    if (c >= d) {
      c -= d;
      ++r;
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ table,
                   const int32_t* __restrict__ idx, float* __restrict__ out,
                   int m, int d, int64_t s, bool vec) {
  __shared__ __align__(16) int s_idx[kWarps][kChunkRows];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int rows_per = vec ? kChunkRows : 32;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t w = (int64_t)blockIdx.x * kWarps + warp; w * rows_per < s;
       w += warps) {
    const int64_t row0 = w * rows_per;
    const int rows = (int)min64(rows_per, s - row0);
    if (vec)
      gather_rows_chunk<kLaneRows>(table, idx, out, s_idx[warp], m, d, row0,
                                   rows, lane);
    else
      gather_rows_chunk<1>(table, idx, out, s_idx[warp], m, d, row0, rows,
                           lane);
  }
}


// K6 and K4: the transposes of K5 and K2, the scatter-add of a cotangent
// into the table: K6 dtable[idx[s], :] += g[s, :] for an (S, D) cotangent
// into an (M, D) table; K4 dtable[:, idx[s]] += g[:, s] for a (D, S)
// cotangent into a (D, M) table.
//
// K6 replaces dimo_tpu/ops/smallgather.py:_bwd_kernel (called through
// _bwd_call by the custom VJP _gs_bwd), K4 _bwd_kernel_cols (through
// _bwd_call_cols by _gc_bwd): one-hot^T @ (hi + lo of g), summed over grid
// steps that the TPU runs in order on one core, so its result is the same
// bits on every run. These kernels keep that: no float atomic anywhere, and
// every entry of the table is summed in a FIXED ORDER that depends only on
// the inputs and the grid (below), so a run on the card gives the same bits
// every time. Both layouts share every kernel here, built once for each
// (kCols).
//
// What bounds them on the H100: bytes: 1.6 MB of indices and 17.6 MB of
// cotangent in, a 22.5 KB table out at the LBS shape (M=512, D=11,
// S=400k), 5.74 us at 3.35 TB/s.
//
// Two routes, chosen by the table's size alone (ops/smallgather.py,
// rows_bwd_plan, the one place of the rule, which cols_bwd_plan calls): the
// TABLE route whenever the table, padded to float4s, fits a block's
// dynamic shared memory (kMaxSmem, 223 KB), the SORTED route otherwise.
//
// Table route: a grid set by the shape alone (rows_bwd_plan: at most
// MAX_BLOCKS = 132 1,024-thread blocks, capped by the 32-site batches; 132
// blocks of 3,040 sites at the LBS shape, one wave on the H100 SXM's 132
// SMs at one resident block each), each over one contiguous range of
// sites. A block zeroes one copy
// of the table in shared memory and takes its range in chunks of kChunk
// sites, in order. For a chunk each thread makes one 32-bit key, (index
// << 10) | the site's place in the chunk, or kNoKey for an index outside
// [0, M); a bitonic network sorts the 1,024 keys (register shuffles for
// the steps within a warp, shared memory for the rest); the first threads
// of each run of equal indices sum its cotangent, kColGroup columns a
// thread, site by site in site order, and add each sum to its table entry:
// each entry has one writer a chunk, so no atomic. The block writes its
// table as one partial of a blocks x M x D scratch (3.0 MB at the LBS
// shape, in L2), and combine_tables_kernel adds the partials in a fixed
// order and writes the output: no zeroing of the output.
//
// The order of the table route, per entry: each chunk's run summed site by
// site from 0; a block's table the chunks' sums added in chunk order from
// 0; the output the partials of blocks w, w + 32, w + 64, ... added in
// order from 0 for w = 0..31, then those 32 sums added in order of w. It
// depends on the grid (blocks, sites a block), which the wrapper's plan
// fixes from (M, D, S) alone, never from the card's SM count or occupancy:
// the same inputs give the same bits on any card, and the plain version,
// on the same plan, sums in the same order, so the two agree bit for bit.
//
// Sorted route, for larger tables (a (100000, 16) table): the wrapper sorts the
// indices with a stable sort (torch.sort, a helper: keys and the sites in
// order), and two passes here sum each run of equal keys in that order.
// segment_tiles_kernel: a thread a (tile of kSegTile sorted positions,
// column) walks its tile, sums each piece of a run site by site from 0,
// writes a run that lies inside the tile to the output (zeroed by the
// caller) and keeps the first and last pieces of a run that crosses the
// tile's edges; segment_runs_kernel: the thread of the tile where such a
// run starts adds its pieces in tile order and writes it. The order of the
// sorted route, per entry: the pieces of the run (its sites in site order,
// cut at every kSegTile-th sorted position) each summed site by site from
// 0, then added in order from 0. It depends on the inputs alone.
//
// What the fixed order costs: the table route sorts each chunk (15 of
// the network's 55 steps behind barriers) and walks each run serially,
// so a hot index is one thread's (a column group's) chain of loads; it
// takes about twice the time of the design it replaces, shared float atomics
// (a compare-and-swap loop on the H100, ATOMS.CAST.SPIN), at the LBS
// shape. The sorted route pays for torch.sort and a serial walk of
// kSegTile positions a thread.
// PERF.md, Findings, has the times, measured in turns with the atomic
// designs on an H100.
//
// An index outside [0, M) adds nothing on either route.
constexpr int kBlockThreads = 1024;    // K6/K4 table route: threads a block
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr int kChunk = kBlockThreads;  // sites a block sorts at a time
constexpr int kLocalBits = 10;         // a site's place in its chunk, in a key
constexpr unsigned kLocalMask = (1u << kLocalBits) - 1;
constexpr unsigned kNoKey = 0xFFFFFFFFu;   // an index outside [0, M)
constexpr int kColGroup = 4;           // columns a run is summed in at a time
constexpr int kSegTile = 128;          // sorted positions a thread walks
// the dynamic shared memory a block of the table route may use: the 227
// KB of a block, less the static key array of a chunk
constexpr int kMaxSmem = 232448 - kBlockWarps * 32 * 4;
static_assert(kChunk == 1 << kLocalBits, "a key holds a chunk's places");
static_assert(kBlockWarps * 32 * 4 == kChunk * 4, "the key array's size");

// floats of the table route's shared table, and of each block's partial:
// m * d padded to float4s
__host__ __device__ inline int64_t table_floats(int m, int d) {
  return ((int64_t)m * d + 3) / 4 * 4;
}

// Where element (site, column) of the cotangent and entry (index, column)
// of the table lie: K6 (kCols false) g[site * d + col], dtable[j * d +
// col]; K4 (kCols true) g[col * s + site], dtable[col * m + j]. Each
// kernel below is built for both.
template <bool kCols>
__device__ __forceinline__ int64_t g_at(int64_t site, int col, int d,
                                        int64_t s) {
  return kCols ? col * s + site : site * d + col;
}

template <bool kCols>
__device__ __forceinline__ int64_t t_at(int j, int col, int m, int d) {
  return kCols ? (int64_t)col * m + j : (int64_t)j * d + col;
}

// Sort a chunk's kChunk keys, one a thread, ascending: a bitonic network.
// A compare-exchange between threads j apart is a register shuffle for j
// < 32 and goes through `keys` in shared memory, behind two barriers,
// for j >= 32 (15 of the network's 55 steps). Returns the thread's key
// in sorted order; `keys` holds the sorted chunk.
__device__ __forceinline__ unsigned sort_chunk(unsigned key, unsigned* keys) {
  const int t = threadIdx.x;
  for (int k = 2; k <= kChunk; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned other;
      if (j >= 32) {
        __syncthreads();                 // the last step's reads are done
        keys[t] = key;
        __syncthreads();
        other = keys[t ^ j];
      } else {
        other = __shfl_xor_sync(0xffffffffu, key, j);
      }
      // an ascending pair leaves the smaller key at the lower thread
      const bool up = (t & k) == 0, low = (t & j) == 0;
      key = low == up ? min(key, other) : max(key, other);
    }
  }
  __syncthreads();
  keys[t] = key;
  __syncthreads();
  return key;
}

template <bool kCols>
__global__ void __launch_bounds__(kBlockThreads, 1)
scatter_block_kernel(const float* __restrict__ g,
                     const int32_t* __restrict__ idx,
                     float* __restrict__ part, int m, int d, int64_t s,
                     int64_t per_block) {
  extern __shared__ __align__(16) float tab[];
  __shared__ unsigned keys[kChunk];
  const int t = threadIdx.x;
  const int64_t tf = table_floats(m, d);
  for (int i = t; i < tf / 4; i += kBlockThreads)
    reinterpret_cast<float4*>(tab)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int64_t b0 = (int64_t)blockIdx.x * per_block;
  const int64_t b1 = min64(s, b0 + per_block);
  for (int64_t c0 = b0; c0 < b1; c0 += kChunk) {
    const int n = (int)min64(kChunk, b1 - c0);
    unsigned key = kNoKey;
    if (t < n) {
      const int j = __ldg(idx + c0 + t);
      if ((unsigned)j < (unsigned)m) key = ((unsigned)j << kLocalBits) | t;
    }
    const unsigned k = sort_chunk(key, keys);
    const unsigned j = k >> kLocalBits;
    // the first `groups` threads of a run each sum its column groups
    // group, group + (run length), ...: every entry has one writer a chunk
    const int groups = (d + kColGroup - 1) / kColGroup;
    int a = t;                           // the run's start, if near enough
    while (a > 0 && t - a < groups && keys[a - 1] >> kLocalBits == j) --a;
    if (k != kNoKey && t - a < groups &&
        (a == 0 || keys[a - 1] >> kLocalBits != j)) {
      int end = t + 1;                   // kNoKey >> kLocalBits is no index
      while (end < kChunk && keys[end] >> kLocalBits == j) ++end;
      for (int grp = t - a; grp < groups; grp += end - a) {
        const int c = grp * kColGroup;
        float acc[kColGroup] = {};
        for (int q = a; q < end; ++q) {  // the run's sites in site order
          const int64_t site = c0 + (keys[q] & kLocalMask);
#pragma unroll
          for (int i = 0; i < kColGroup; ++i)
            if (c + i < d) acc[i] += __ldg(g + g_at<kCols>(site, c + i, d, s));
        }
#pragma unroll
        for (int i = 0; i < kColGroup; ++i)
          if (c + i < d) tab[t_at<kCols>(j, c + i, m, d)] += acc[i];
      }
    }
    __syncthreads();                     // the chunk's adds, then new keys
  }
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(part + blockIdx.x * tf);
  for (int i = t; i < tf / 4; i += kBlockThreads)
    out[i] = reinterpret_cast<const float4*>(tab)[i];
}

// The second pass of the table route: dtable[e] = the sum of the blocks'
// partials at e, in a fixed order. A block of 32 warps takes 32 entries;
// warp w sums blocks w, w + 32, ... in order, and lane e of warp 0 adds
// the 32 sums in warp order.
constexpr int kCombineWarps = 32;
__global__ void __launch_bounds__(32 * kCombineWarps)
combine_tables_kernel(const float* __restrict__ part,
                      float* __restrict__ dtable, int tn, int64_t tf,
                      int blocks) {
  __shared__ float red[kCombineWarps][33];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  float acc = 0.0f;
  if (e < tn) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += kCombineWarps)
      acc += part[b * tf + e];
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && e < tn) {
    float v = red[0][lane];
#pragma unroll
    for (int w = 1; w < kCombineWarps; ++w) v += red[w][lane];
    dtable[e] = v;
  }
}

// The sorted route's first pass (see above K6): thread (tile, column).
// head[tile] receives the tile's first piece when its run began in an
// earlier tile, tail[tile] its last piece when its run goes on past it.
// Positions are read kSegLoads at a time, their loads issued together,
// then added one by one.
constexpr int kSegLoads = 8;
template <bool kCols>
__global__ void __launch_bounds__(256)
segment_tiles_kernel(const float* __restrict__ g,
                     const int32_t* __restrict__ keys,
                     const int64_t* __restrict__ order,
                     float* __restrict__ dtable, float* __restrict__ head,
                     float* __restrict__ tail, int m, int d, int64_t s,
                     int64_t tiles) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= tiles * d) return;
  const int64_t tile = gid / d;
  const int c = (int)(gid - tile * d);
  const int64_t p0 = tile * kSegTile, p1 = min64(s, p0 + kSegTile);
  const bool from_before = p0 > 0 && keys[p0 - 1] == keys[p0];
  const bool goes_on = p1 < s && keys[p1] == keys[p1 - 1];
  float acc = 0.0f;
  int j = keys[p0];
  int64_t first = p0;                    // the current piece's start
  for (int64_t q = p0; q < p1; q += kSegLoads) {
    int jq[kSegLoads];
    float v[kSegLoads];
#pragma unroll
    for (int i = 0; i < kSegLoads; ++i) {
      if (q + i < p1) {
        jq[i] = keys[q + i];
        v[i] = __ldg(g + g_at<kCols>(order[q + i], c, d, s));
      }
    }
#pragma unroll
    for (int i = 0; i < kSegLoads; ++i) {
      if (q + i >= p1) break;
      if (jq[i] != j) {                  // the piece [first, q + i) of run j
        if (first == p0 && from_before)
          head[tile * d + c] = acc;
        else if ((unsigned)j < (unsigned)m)
          dtable[t_at<kCols>(j, c, m, d)] = acc;
        acc = 0.0f;
        j = jq[i];
        first = q + i;
      }
      acc += v[i];
    }
  }
  if (goes_on) {                         // the piece [first, p1) goes on
    tail[tile * d + c] = acc;
    if (first == p0 && from_before) head[tile * d + c] = acc;
  } else if (first == p0 && from_before) {
    head[tile * d + c] = acc;
  } else if ((unsigned)j < (unsigned)m) {
    dtable[t_at<kCols>(j, c, m, d)] = acc;
  }
}

// The sorted route's second pass: the thread (tile, column) of the tile
// where a run that goes on past the tile starts adds the run's pieces in
// tile order: its own last piece, then each later tile's first piece. It
// finds the run's last tile first (a binary search), so the loads of the
// pieces are issued kSegLoads at a time ahead of their adds.
template <bool kCols>
__global__ void __launch_bounds__(256)
segment_runs_kernel(const int32_t* __restrict__ keys,
                    const float* __restrict__ head,
                    const float* __restrict__ tail, float* __restrict__ dtable,
                    int m, int d, int64_t s, int64_t tiles) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= tiles * d) return;
  const int64_t tile = gid / d;
  const int c = (int)(gid - tile * d);
  const int64_t p0 = tile * kSegTile, p1 = min64(s, p0 + kSegTile);
  const int j = keys[p1 - 1];
  if (p1 >= s || keys[p1] != j) return;          // its last run ends here
  if (p0 > 0 && keys[p0 - 1] == j) return;       // ... or began before it
  int64_t lo = p1, hi = s;               // the run's end: the first key > j
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (keys[mid] == j) lo = mid + 1; else hi = mid;
  }
  const int64_t last = (lo - 1) / kSegTile;      // the run's last tile
  float acc = tail[tile * d + c];
  for (int64_t u = tile + 1; u <= last; u += kSegLoads) {
    float v[kSegLoads];
#pragma unroll
    for (int i = 0; i < kSegLoads; ++i)
      if (u + i <= last) v[i] = head[(u + i) * d + c];
#pragma unroll
    for (int i = 0; i < kSegLoads; ++i)
      if (u + i <= last) acc += v[i];
  }
  if ((unsigned)j < (unsigned)m) dtable[t_at<kCols>(j, c, m, d)] = acc;
}

// Allow the table route's kernel the most dynamic shared memory a block
// may use, once per device.
cudaError_t allow_table_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(scatter_block_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(scatter_block_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

// The table route (both passes) of K6 or K4.
template <bool kCols>
int scatter_tables(const float* g, const int32_t* idx, float* part,
                   float* dtable, int m, int d, int64_t s, int blocks,
                   int64_t per_block, int64_t smem, cudaStream_t stream) {
  if (smem != 4 * table_floats(m, d) || smem > kMaxSmem || blocks < 1 ||
      (int64_t)blocks * per_block < s || m >= (1 << (32 - kLocalBits)) - 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_table_smem();
  if (e != cudaSuccess) return (int)e;
  scatter_block_kernel<kCols><<<blocks, kBlockThreads, (size_t)smem,
                                 stream>>>(g, idx, part, m, d, s, per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tn = m * d;
  combine_tables_kernel<<<(tn + 31) / 32, 32 * kCombineWarps, 0, stream>>>(
      part, dtable, tn, table_floats(m, d), blocks);
  return (int)cudaGetLastError();
}

// The sorted route (both passes) of K6 or K4.
template <bool kCols>
int scatter_sorted(const float* g, const int32_t* keys, const int64_t* order,
                   float* head, float* tail, float* dtable, int m, int d,
                   int64_t s, cudaStream_t stream) {
  if (s <= 0 || d <= 0) return 0;
  const int64_t tiles = (s + kSegTile - 1) / kSegTile;
  const int64_t blocks = (tiles * d + 255) / 256;
  segment_tiles_kernel<kCols><<<(unsigned)blocks, 256, 0, stream>>>(
      g, keys, order, dtable, head, tail, m, d, s, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  segment_runs_kernel<kCols><<<(unsigned)blocks, 256, 0, stream>>>(
      keys, head, tail, dtable, m, d, s, tiles);
  return (int)cudaGetLastError();
}

// The strip path's row scatter (ops/rasterizer/gather.py::gather_rows_bwd):
// dtable[idx[s], :] += g[s, :] for K3's per-slot gradients of the strip
// lists, g (T, C, A) at idx (T, C), into the (M, A) coefficient table,
// over the LIVE slots only: slot (t, c) with c < count[t] when the strips'
// counts are given (K3 writes 0 past a count; the spatially sharded
// render zeroes the count of the strips a rank does not own), every slot
// otherwise (the tile path). It has no TPU kernel: the reference's is
// XLA's sort + cumsum (dimo_tpu/ops/rasterizer/gather.py:34).
//
// What bounds it on the H100: bytes: at the flagship frame (256 strips x
// 1,024 slots, 161,896 of them live, M = 100,001, A = 16) the live slots'
// 68 bytes in and 64 bytes a row out, 17.4 MB, 5.2 us at 3.35 TB/s.
//
// The ORDER, per entry of the output, which depends on the inputs alone:
// the row's slots are cut by their flat slot index (t * C + c) into
// chunks of kChunk = 1,024; each chunk's slots of the row are added one
// by one in slot order from 0, then the chunks' sums in chunk order from
// 0. A slot outside its count, and an index outside [0, M), adds nothing.
// Since the cuts fall at fixed slot indices, dropping a slot whose value
// is 0 changes no bit (x + 0 = x, and a sum that starts at +0 never
// reaches -0), so the live route equals the all-slot route on K3's
// gradients bit for bit.
//
// Design. On NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py --phase parts;
// PERF.md, Findings), the route this replaces (the sorted route above, on
// every slot) took 0.1225 ms in a CUDA graph: torch.sort 0.054 ms, its two
// passes 0.060 ms, a serial walk of the 783 tiles of the dummy row's run
// among them; the lists hold at most 20 live slots a row and no strip
// lists a row twice. So this route sorts nothing it need not:
//   chunk_runs_kernel, a 1,024-thread block a chunk: marks each live row
//     of the chunk in a bitmap, bit k of row r's `words` words for chunk k
//     (an integer atomicOr: the bits do not depend on the order), and
//     counts the (row, chunk) runs of each 1,024-row block (shared, then
//     one global integer atomicAdd a row block). A thread whose bit was
//     already set found a row listed twice in its chunk; only then does
//     the block sort the chunk's keys, (row << 10) | place, by the bitonic
//     network of the table route, so each run of a row is contiguous in
//     slot order. The chunk's keys, sorted or in slot order, go to `keys`.
//   row_starts_kernel, a 1,024-thread block a row block: each row's runs
//     (the popcount of its words), their exclusive sum across rows
//     (`start`, with the earlier row blocks' counts added first).
//   run_sums_kernel, a thread a chunk position: the head of each run
//     finds its place in its row's list, start[row] + (the row's chunks
//     before this one: a popcount of its bitmap words), and writes there
//     the run's slot when the run is one slot (at the flagship frame,
//     every run), else ~(its chunk position), after summing the run's g
//     in slot order into part at that position. So each row's list holds
//     its chunk sums in chunk order, and no row of g is copied.
//   sum_rows_kernel, four threads a row, a float4 each: the row's chunk
//     sums (rows of g, or of part) added in list order, every row written
//     once (0 where nothing lands): no zeroing of the output.
// No float atomic, no host read; the wrapper's scratch is sized by the
// shapes, so a CUDA graph captures the route. Measured the same way, in
// turns with the sorted route: 0.0285-0.0289 ms against 0.122-0.129 (the
// row sums 9 us, the run sums 7.5). Not kept: every run's sum copied into
// part, then read back in row order, 0.0375 ms (its run sums 19 us).
constexpr int kRowBlockBits = 10;       // rows a block of row_starts_kernel
constexpr int kRowBlock = 1 << kRowBlockBits;
constexpr int kRowLanes = 4;            // threads a row in sum_rows_kernel
constexpr int kRunVecs = 4;             // float4s a run_sums_kernel pass sums
static_assert(kRowBlock == kBlockThreads, "a thread a row");

__global__ void __launch_bounds__(kBlockThreads)
chunk_runs_kernel(const int32_t* __restrict__ idx,
                  const int32_t* __restrict__ count, int cap, int m,
                  int64_t s, int words, unsigned* __restrict__ bitmap,
                  int* __restrict__ row_runs, unsigned* __restrict__ keys_out) {
  extern __shared__ int blk_runs[];      // runs a row block, this chunk
  __shared__ unsigned keys[kChunk];
  const int t = threadIdx.x;
  const int nblk = (m + kRowBlock - 1) / kRowBlock;
  for (int i = t; i < nblk; i += kBlockThreads) blk_runs[i] = 0;
  __syncthreads();
  const int64_t k = blockIdx.x;
  const int64_t slot = k * kChunk + t;
  unsigned key = kNoKey;
  bool dup = false;
  if (slot < s && (count == nullptr || slot % cap < __ldg(count + slot / cap))) {
    const int r = __ldg(idx + slot);
    if ((unsigned)r < (unsigned)m) {
      key = ((unsigned)r << kLocalBits) | t;
      const unsigned bit = 1u << (k & 31);
      dup = atomicOr(bitmap + (int64_t)r * words + (k >> 5), bit) & bit;
      if (!dup) atomicAdd(blk_runs + (r >> kRowBlockBits), 1);
    }
  }
  if (__syncthreads_or(dup)) key = sort_chunk(key, keys);
  keys_out[slot] = key;
  for (int i = t; i < nblk; i += kBlockThreads)
    if (blk_runs[i]) atomicAdd(row_runs + i, blk_runs[i]);
}

// The sum of v over the block's threads (every thread gets it); `red`
// holds kBlockWarps ints.
__device__ __forceinline__ int block_sum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = 0;
  for (int w = 0; w < kBlockWarps; ++w) v += red[w];
  return v;
}

__global__ void __launch_bounds__(kBlockThreads)
row_starts_kernel(const unsigned* __restrict__ bitmap,
                  const int* __restrict__ row_runs, int words, int m,
                  int* __restrict__ start) {
  __shared__ int red[kBlockWarps];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  int before = 0;                        // the runs of earlier row blocks
  for (int i = t; i < (int)blockIdx.x; i += kBlockThreads)
    before += row_runs[i];
  before = block_sum(before, red);
  const int r = blockIdx.x * kRowBlock + t;
  int n = 0;
  if (r < m)
    for (int w = 0; w < words; ++w)
      n += __popc(__ldg(bitmap + (int64_t)r * words + w));
  int incl = n;                          // inclusive scan over the block
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  __syncthreads();
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += red[w];
  if (r < m) start[r + 1] = before + incl;
  if (r == 0) start[0] = 0;
}

// The count of row r's chunks before chunk k: the popcount of its bitmap
// bits below k, its words read four at a time where they are 16-byte
// aligned.
__device__ __forceinline__ int chunks_before(const unsigned* __restrict__ row,
                                             int words, int64_t k) {
  const int kw = (int)(k >> 5);
  const unsigned below = (1u << (k & 31)) - 1;
  int rank = 0;
  if (words % 4 == 0) {
    for (int w = 0; w <= kw; w += 4) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + w));
      const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (w + i <= kw) rank += __popc(w + i < kw ? u[i] : u[i] & below);
    }
    return rank;
  }
#pragma unroll 4
  for (int w = 0; w <= kw; ++w) {
    const unsigned word = __ldg(row + w);
    rank += __popc(w < kw ? word : word & below);
  }
  return rank;
}

__global__ void __launch_bounds__(kBlockThreads)
run_sums_kernel(const float* __restrict__ g, const unsigned* __restrict__ keys,
                const unsigned* __restrict__ bitmap,
                const int* __restrict__ start, int words, int a4,
                float* __restrict__ part, int* __restrict__ list) {
  const int t = threadIdx.x;
  const int64_t k = blockIdx.x;
  const int64_t base = k * kChunk;
  const unsigned key = keys[base + t];
  if (key == kNoKey) return;
  const unsigned r = key >> kLocalBits;
  if (t > 0 && keys[base + t - 1] >> kLocalBits == r) return;  // not a head
  int end = t + 1;                       // the run: keys[t, end)
  while (end < kChunk && keys[base + end] >> kLocalBits == r) ++end;
  const int at = __ldg(start + r) +
                 chunks_before(bitmap + (int64_t)r * words, words, k);
  if (end == t + 1) {                    // one slot: its row of g is the sum
    list[at] = (int)(base + (key & kLocalMask));
    return;
  }
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* p4 = reinterpret_cast<float4*>(part) + (base + t) * a4;
  for (int f0 = 0; f0 < a4; f0 += kRunVecs) {
    float4 acc[kRunVecs];
#pragma unroll
    for (int i = 0; i < kRunVecs; ++i)
      acc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int q = t; q < end; ++q) {      // the run's slots in slot order
      const unsigned kq = q == t ? key : keys[base + q];
      const float4* src = g4 + (base + (kq & kLocalMask)) * a4 + f0;
#pragma unroll
      for (int i = 0; i < kRunVecs; ++i) {
        if (f0 + i < a4) {
          const float4 v = __ldg(src + i);
          acc[i].x += v.x;
          acc[i].y += v.y;
          acc[i].z += v.z;
          acc[i].w += v.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRunVecs; ++i)
      if (f0 + i < a4) p4[f0 + i] = acc[i];
  }
  list[at] = ~(int)(base + t);           // the sum lies in part
}

__global__ void __launch_bounds__(256)
sum_rows_kernel(const float* __restrict__ g, const float* __restrict__ part,
                const int* __restrict__ list, const int* __restrict__ start,
                int m, int a4, float* __restrict__ out) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t r = gid / kRowLanes;
  if (r >= m) return;
  const int j0 = __ldg(start + r), j1 = __ldg(start + r + 1);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* p4 = reinterpret_cast<const float4*>(part);
  for (int f = (int)(gid % kRowLanes); f < a4; f += kRowLanes) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {      // the chunks in order
      const int e = __ldg(list + j);
      const float4 v = __ldg((e >= 0 ? g4 + (int64_t)e * a4
                                     : p4 + (int64_t)~e * a4) + f);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    reinterpret_cast<float4*>(out)[r * a4 + f] = acc;
  }
}

}  // namespace

// table: (m, d) float32; idx: (s,) int32; out: (s, d) float32.
// Returns cudaError_t.
extern "C" int gather_small_rows_fwd(const float* table, const int32_t* idx,
                                     float* out, int m, int d, int64_t s,
                                     int num_sms, cudaStream_t stream) {
  if (s <= 0 || d <= 0) return 0;
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gather_rows_kernel, kThreads, 0);
    if (e != cudaSuccess) return (int)e;
  }
  const bool vec = s % kLaneRows == 0 &&
                   (reinterpret_cast<uintptr_t>(idx) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int64_t rows_per = vec ? kChunkRows : 32;
  const int64_t chunks = (s + rows_per - 1) / rows_per;
  int64_t blocks = (chunks + kWarps - 1) / kWarps;
  const int64_t cap = (int64_t)per_sm * num_sms;
  if (blocks > cap) blocks = cap;
  gather_rows_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      table, idx, out, m, d, s, vec);
  return (int)cudaGetLastError();
}

// K6's table route. g: (s, d) float32; part: (blocks, table_floats)
// float32 scratch (m * d rounded up to a multiple of 4); dtable: (m, d)
// float32, written whole. blocks and per_block come from
// ops/smallgather.py::rows_bwd_plan; smem must equal table_floats * 4.
// Returns cudaError_t.
extern "C" int gather_small_rows_bwd_tables(const float* g, const int32_t* idx,
                                            float* part, float* dtable, int m,
                                            int d, int64_t s, int blocks,
                                            int64_t per_block, int64_t smem,
                                            cudaStream_t stream) {
  return scatter_tables<false>(g, idx, part, dtable, m, d, s, blocks,
                               per_block, smem, stream);
}

// K6's sorted route. g: (s, d) float32; keys: (s,)
// int32, the indices sorted stably; order: (s,) int64, the site of each
// sorted position; head, tail: (ceil(s / kSegTile), d) float32 scratch;
// dtable: (m, d) float32, zeroed by the caller. Returns cudaError_t.
extern "C" int gather_small_rows_bwd_sorted(const float* g,
                                            const int32_t* keys,
                                            const int64_t* order, float* head,
                                            float* tail, float* dtable, int m,
                                            int d, int64_t s,
                                            cudaStream_t stream) {
  return scatter_sorted<false>(g, keys, order, head, tail, dtable, m, d, s,
                               stream);
}

// blocks: (3,) int32, receives the resident blocks per SM of K5, of the
// table route's kernel at `smem` bytes of dynamic shared memory, and of
// its second pass on the current device. Returns cudaError_t.
extern "C" int gather_small_rows_occupancy(int64_t smem, int* blocks) {
  cudaError_t e = allow_table_smem();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[0], gather_rows_kernel, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[1], scatter_block_kernel<false>, kBlockThreads,
        (size_t)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[2], combine_tables_kernel, 32 * kCombineWarps, 0);
  return (int)e;
}

// K4's table route. g: (d, s) float32; part: (blocks, table_floats)
// float32 scratch (d * m rounded up to a multiple of 4); dtable: (d, m)
// float32, written whole. blocks and per_block come from
// ops/smallgather.py::cols_bwd_plan; smem must equal table_floats * 4.
// Returns cudaError_t.
extern "C" int gather_small_cols_bwd_tables(const float* g, const int32_t* idx,
                                            float* part, float* dtable, int d,
                                            int m, int64_t s, int blocks,
                                            int64_t per_block, int64_t smem,
                                            cudaStream_t stream) {
  return scatter_tables<true>(g, idx, part, dtable, m, d, s, blocks,
                              per_block, smem, stream);
}

// K4's sorted route. g: (d, s) float32; keys, order, head, tail as K6's;
// dtable: (d, m) float32, zeroed by the caller. Returns cudaError_t.
extern "C" int gather_small_cols_bwd_sorted(const float* g,
                                            const int32_t* keys,
                                            const int64_t* order, float* head,
                                            float* tail, float* dtable, int d,
                                            int m, int64_t s,
                                            cudaStream_t stream) {
  return scatter_sorted<true>(g, keys, order, head, tail, dtable, m, d, s,
                              stream);
}

// blocks: (2,) int32, receives the resident blocks per SM of the table
// route's kernel at `smem` bytes of dynamic shared memory and of its second
// pass on the current device. Returns cudaError_t.
extern "C" int gather_small_cols_occupancy(int64_t smem, int* blocks) {
  cudaError_t e = allow_table_smem();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[0], scatter_block_kernel<true>, kBlockThreads, (size_t)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[1], combine_tables_kernel, 32 * kCombineWarps, 0);
  return (int)e;
}

// The strip path's row scatter (above run_sums_kernel). g: (s, a)
// float32, 16-byte aligned, a % 4 == 0; idx: (s,) int32; count: (s / cap,)
// int32, or null for every slot live; marks: (m * words + ceil(m / 1024))
// int32 scratch, words = ceil(ceil(s / 1024) / 32), zeroed here; keys:
// (ceil(s / 1024) * 1024,) int32 scratch; start: (m + 1,) int32 scratch;
// list: (s,) int32 scratch; part: (ceil(s / 1024) * 1024, a) float32
// scratch; out: (m, a) float32, written whole. s < 2^31 - 1024.
// Returns cudaError_t.
extern "C" int gather_rows_bwd_chunked(const float* g, const int32_t* idx,
                                       const int32_t* count, int cap,
                                       int32_t* marks, int32_t* keys,
                                       int32_t* start, int32_t* list,
                                       float* part, float* out, int m, int a,
                                       int64_t s, cudaStream_t stream) {
  if (m <= 0 || a <= 0) return 0;
  if (a % 4 != 0 || m >= (1 << (32 - kLocalBits)) - 1 || s < 0 ||
      s > INT32_MAX - kChunk ||
      (count != nullptr && s > 0 && cap <= 0) ||
      (reinterpret_cast<uintptr_t>(g) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t chunks = (s + kChunk - 1) / kChunk;
  const int words = (int)((chunks + 31) / 32);
  const int nblk = (m + kRowBlock - 1) / kRowBlock;
  unsigned* bitmap = reinterpret_cast<unsigned*>(marks);
  int* row_runs = marks + (int64_t)m * words;
  cudaError_t e = cudaMemsetAsync(
      marks, 0, ((int64_t)m * words + nblk) * sizeof(int32_t), stream);
  if (e != cudaSuccess) return (int)e;
  if (chunks > 0) {
    chunk_runs_kernel<<<(unsigned)chunks, kBlockThreads,
                        nblk * sizeof(int), stream>>>(
        idx, count, cap, m, s, words, bitmap, row_runs,
        reinterpret_cast<unsigned*>(keys));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  row_starts_kernel<<<nblk, kBlockThreads, 0, stream>>>(bitmap, row_runs,
                                                        words, m, start);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (chunks > 0) {
    run_sums_kernel<<<(unsigned)chunks, kBlockThreads, 0, stream>>>(
        g, reinterpret_cast<const unsigned*>(keys), bitmap, start, words,
        a / 4, part, list);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t threads = (int64_t)m * kRowLanes;
  sum_rows_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      g, part, list, start, m, a / 4, out);
  return (int)cudaGetLastError();
}
