// LBS column gather (kernel K2): out[d, s] = table[d, idx[s]] for a small
// (D, M) table, and its transpose (kernel K4, described above its kernel):
// dtable[d, idx[s]] += g[d, s]; and the same pair in row layout, K5
// (out[s, :] = table[idx[s], :]) and K6 (its transpose), each described
// above its kernel.
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


// K6: K5's transpose, dtable[idx[s], :] += g[s, :] for an (S, D) cotangent
// into the (M, D) table.
//
// Replaces dimo_tpu/ops/smallgather.py:_bwd_kernel (called through
// _bwd_call by the custom VJP _gs_bwd), one-hot^T @ (hi + lo of g) summed
// over grid steps on the TPU.
//
// What bounds it on the H100: bytes: 1.6 MB of indices and 17.6 MB of
// cotangent in, a 22.5 KB table out at the LBS shape, 5.74 us at
// 3.35 TB/s. One global float atomic an element, ~780 onto each of the
// 5,632 entries, is bound by the L2's atomic units instead.
//
// Two routes, chosen by the table's size alone (ops/smallgather.py,
// rows_bwd_plan, the one place of the rule): the TABLE route whenever the
// table, padded to float4s, fits a block's dynamic shared memory
// (kMaxSmem, 223 KB), the ATOMIC route otherwise. Neither is
// deterministic: both add with float atomics, in an order that varies
// from run to run.
//
// Table route: one wave of 1,024-thread blocks (the occupancy API's
// resident blocks per SM at the table's shared memory, times the SMs: 261
// at the LBS shape), each over one contiguous range of sites. A block
// zeroes one copy of the table in shared memory; each warp takes 32
// sites at a time, lane l the cotangent floats l, l + 32, ... of the
// batch (coalesced), with the (row, col) of each stepped, no division, and
// issues four loads before their four shared atomicAdds. The block then
// writes its table as one partial of a blocks x M x D scratch (5.9 MB at
// the LBS shape, in L2), and combine_tables_kernel adds the partials in a
// fixed order (warp w of a 32-warp block sums blocks w, w + 32, ...; warp
// 0 adds the 32 sums in warp order) and writes the output: no global
// atomic, no zeroing of the output.
//
// Atomic route, for larger tables (a (100000, 16) table): threads walk
// the flattened (S*D) cotangent and add each element into the output
// (zeroed by the caller) with one global atomic; at such M the atomics
// rarely meet.
//
// Measured in a CUDA graph on NVIDIA H100 80GB HBM3, 700.00 W
// (chip_smoke.py, PERF.md, Findings), in turns, at the LBS shape: the
// table route 15.48-15.51 us against 33.93-34.29 for the atomic route
// alone (its design before), and zeros + index_add_ 32.2. Designs that
// lost, in the same run:
//  - private tables per warp (8 of 22.5 KB in 1 block an SM), added in
//    a fixed order, bit-identical on every run: 19.47-19.50 us with
//    __match_any_sync groups and one row update a round; 17.64-17.65 with
//    groups from ballots on the index bits, 64-site windows and the
//    group's first site adding its peers before one update; 33.7 with
//    __match_any_sync and the first lane summing its peers column by
//    column. Timing parts of the first: staging the cotangent alone
//    4.88 us, with the tables zeroed and added up 6.2, with the row
//    updates but no grouping 10.8-11.0, whole 16.9-17.1: eight warps an
//    SM leave the per-warp chain of shared-memory latencies exposed;
//  - this design with scalar loads, one at a time, and an 8-warp second
//    pass: 17.21-17.31 us; with 8 loads in flight: 16.0-16.4; with one
//    block an SM (131 partials): 15.35-15.38, not taken (the grid is
//    sized by the occupancy API).
//
// An index outside [0, M) adds nothing on either route.
constexpr int kBlockThreads = 1024;    // K6/K4 table routes: threads a block
constexpr int kBlockWarps = kBlockThreads / 32;
// the dynamic shared memory a block of K6's (or K4's) table kernel may
// use: the 227 KB of a block, less K6's static index array
constexpr int kMaxSmem = 232448 - kBlockWarps * 32 * 4;

// floats of K6's (and K4's) shared table, and of each block's partial:
// m * d padded to float4s
__host__ __device__ inline int64_t table_floats(int m, int d) {
  return ((int64_t)m * d + 3) / 4 * 4;
}

__global__ void __launch_bounds__(kBlockThreads)
scatter_rows_block_kernel(const float* __restrict__ g,
                          const int32_t* __restrict__ idx,
                          float* __restrict__ part, int m, int d, int64_t s,
                          int64_t per_block) {
  extern __shared__ __align__(16) float tab[];
  __shared__ int wi[kBlockWarps][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t tf = table_floats(m, d);
  for (int i = threadIdx.x; i < tf / 4; i += kBlockThreads)
    reinterpret_cast<float4*>(tab)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  // the block's sites [b0, b1), 32 at a time a warp; lane l takes
  // elements l, l + 32, ... of the batch's n*d cotangent floats, four
  // loads in flight before their four shared atomics
  const int64_t b0 = (int64_t)blockIdx.x * per_block;
  const int64_t b1 = min64(s, b0 + per_block);
  const int dr = 32 / d, dc = 32 - dr * d;     // (row, col) step of 32
  const int r0 = lane / d, c0 = lane - r0 * d;
  for (int64_t s0 = b0 + 32 * warp; s0 < b1; s0 += 32 * kBlockWarps) {
    const int n = (int)min64(32, b1 - s0);
    wi[warp][lane] = lane < n ? __ldg(idx + s0 + lane) : -1;
    __syncwarp();
    const float* src = g + s0 * d;
    const int ne = n * d;
    int r = r0, c = c0;
    for (int e = lane; e < ne; e += 128) {
      float v[4];
      int at[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ek = e + 32 * k;
        at[k] = -1;
        if (ek < ne) {
          const int j = wi[warp][r];
          v[k] = __ldg(src + ek);
          if ((unsigned)j < (unsigned)m) at[k] = j * d + c;
        }
        r += dr;
        c += dc;
        if (c >= d) {
          c -= d;
          ++r;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (at[k] >= 0) atomicAdd(&tab[at[k]], v[k]);
    }
    __syncwarp();
  }
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(part + blockIdx.x * tf);
  for (int i = threadIdx.x; i < tf / 4; i += kBlockThreads)
    out[i] = reinterpret_cast<const float4*>(tab)[i];
}

// The second pass of K6 and K4: dtable[e] = the sum of the blocks'
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

// K6's atomic route (see above K6).
__global__ void scatter_rows_kernel(const float* __restrict__ g,
                                    const int32_t* __restrict__ idx,
                                    float* __restrict__ dtable, int m, int d,
                                    int64_t s) {
  const int64_t total = s * d;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t row = i / d;
    const int col = (int)(i - row * d);
    const int j = idx[row];
    if (j < 0 || j >= m) continue;
    atomicAdd(&dtable[(int64_t)j * d + col], g[i]);
  }
}

// K4: K2's transpose, dtable[d, idx[s]] += g[d, s] for a (D, S) cotangent
// into the (D, M) table.
//
// Replaces dimo_tpu/ops/smallgather.py:_bwd_kernel_cols (called through
// _bwd_call_cols by the custom VJP _gc_bwd), a one-hot bf16 hi+lo matmul
// on the TPU.
//
// What bounds it on the H100: bytes, as K6: 1.6 MB of indices and 17.6 MB
// of cotangent in, a 22.5 KB table out at the LBS shape (D=11, M=512,
// S=400k), 5.74 us at 3.35 TB/s.
//
// K6's two routes in column layout, chosen by the table's size alone by
// the same rule (ops/smallgather.py, cols_bwd_plan beside rows_bwd_plan):
// the TABLE route whenever the (D, M) table, padded to float4s, fits a
// block's dynamic shared memory (kMaxSmem), the ATOMIC route otherwise.
// Neither is deterministic: both add with float atomics, in an order that
// varies from run to run.
//
// Table route: one wave of 1,024-thread blocks (the occupancy API's
// resident blocks per SM times the SMs, capped by the 32-site batches:
// 261 blocks of 1,536 sites at the LBS shape, K6's grid), each over one
// contiguous range of sites. A block zeroes one shared copy of the (D, M)
// table; a thread takes one site a step (a warp's index and cotangent
// loads are 128 coalesced bytes each) and issues kColRows row loads before
// their shared atomics. The block writes its table as one partial of a
// blocks x (D x M) scratch (5.9 MB at the LBS shape, in L2), and K6's
// combine_tables_kernel adds the partials in a fixed order and writes the
// output: no global atomic, no zeroing of the output.
//
// Atomic route, for larger tables: threads walk the sites grid-stride,
// one index load and D coalesced cotangent loads a site, and add each
// element into the output (zeroed by the caller) with one global atomic.
//
// What holds the table route back: a float atomicAdd on shared memory is
// a compare-and-swap loop on the H100 (ATOMS.CAST.SPIN in the SASS; on
// global memory it is one native REDG.E.ADD.F32), 4.4 M of them at the LBS
// shape, to random banks.
//
// Measured in a CUDA graph on NVIDIA H100 80GB HBM3, 700.00 W
// (chip_smoke.py, PERF.md, Findings), in turns at the LBS shape: 19.33-19.35 us
// (32 registers, 2 blocks an SM) against 32.18-32.55 for the design it
// replaced (a grid of 2 blocks of 256 threads an SM adding shared copies
// into a zeroed output with global atomics), and zeros + index_add_ 384.
// Designs that lost, in the same runs: a thread owning four sites with
// one int4 index and one float4 cotangent load a row, as K2 (48 registers,
// 1 block an SM) 20.97-20.99 us, at 2 blocks an SM 22.51-22.58; one or two
// rows in flight 19.53-19.54 / 19.29-19.32, eight 19.48-19.52, all eleven
// 26.56-26.67; 512-thread blocks, 4 an SM, 19.91-20.13; two rows added by
// one 64-bit compare-and-swap loop 61.8; global atomics into each block's
// own partial instead of shared ones 59.9-75.4.
//
// An index outside [0, M) adds nothing on either route.
constexpr int kColRows = 4;    // K4: cotangent rows loaded before their adds

__global__ void __launch_bounds__(kBlockThreads, 2)
scatter_cols_block_kernel(const float* __restrict__ g,
                          const int32_t* __restrict__ idx,
                          float* __restrict__ part, int d, int m, int64_t s,
                          int64_t per_block) {
  extern __shared__ __align__(16) float tab[];
  const int64_t tf = table_floats(m, d);
  for (int i = threadIdx.x; i < tf / 4; i += kBlockThreads)
    reinterpret_cast<float4*>(tab)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const int64_t b0 = (int64_t)blockIdx.x * per_block;
  const int64_t b1 = min64(s, b0 + per_block);
  for (int64_t site = b0 + threadIdx.x; site < b1; site += kBlockThreads) {
    const int j = __ldg(idx + site);
    if ((unsigned)j >= (unsigned)m) continue;
    for (int r0 = 0; r0 < d; r0 += kColRows) {
      float v[kColRows];
#pragma unroll
      for (int i = 0; i < kColRows; ++i)
        if (r0 + i < d) v[i] = __ldg(g + (int64_t)(r0 + i) * s + site);
#pragma unroll
      for (int i = 0; i < kColRows; ++i)
        if (r0 + i < d) atomicAdd(tab + (r0 + i) * m + j, v[i]);
    }
  }
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(part + blockIdx.x * tf);
  for (int i = threadIdx.x; i < tf / 4; i += kBlockThreads)
    out[i] = reinterpret_cast<const float4*>(tab)[i];
}

// K4's atomic route (see above K4).
__global__ void scatter_cols_kernel(const float* __restrict__ g,
                                    const int32_t* __restrict__ idx,
                                    float* __restrict__ dtable, int d, int m,
                                    int64_t s) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t site = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       site < s; site += stride) {
    const int j = __ldg(idx + site);
    if ((unsigned)j >= (unsigned)m) continue;
    for (int r = 0; r < d; ++r)
      atomicAdd(dtable + (int64_t)r * m + j, __ldg(g + (int64_t)r * s + site));
  }
}

// Allow the table kernels of K6 and K4 the most dynamic shared memory a
// block may use, once per device.
cudaError_t allow_table_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(scatter_rows_block_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(scatter_cols_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
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
  if (smem != 4 * table_floats(m, d) || smem > kMaxSmem || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_table_smem();
  if (e != cudaSuccess) return (int)e;
  scatter_rows_block_kernel<<<blocks, kBlockThreads, (size_t)smem, stream>>>(
      g, idx, part, m, d, s, per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tn = m * d;
  combine_tables_kernel<<<(tn + 31) / 32, 32 * kCombineWarps, 0, stream>>>(
      part, dtable, tn, table_floats(m, d), blocks);
  return (int)cudaGetLastError();
}

// K6's atomic route. g: (s, d) float32; dtable: (m, d) float32, zeroed by
// the caller. Returns cudaError_t.
extern "C" int gather_small_rows_bwd_atomics(const float* g,
                                             const int32_t* idx,
                                             float* dtable, int m, int d,
                                             int64_t s, int num_sms,
                                             cudaStream_t stream) {
  int64_t blocks = (s * d + kThreads - 1) / kThreads;
  const int64_t cap = 2 * (int64_t)num_sms;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  scatter_rows_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      g, idx, dtable, m, d, s);
  return (int)cudaGetLastError();
}

// blocks: (3,) int32, receives the resident blocks per SM of K5, of K6's
// table kernel at `smem` bytes of dynamic shared memory, and of K6's
// second pass on the current device. Returns cudaError_t.
extern "C" int gather_small_rows_occupancy(int64_t smem, int* blocks) {
  cudaError_t e = allow_table_smem();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[0], gather_rows_kernel, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[1], scatter_rows_block_kernel, kBlockThreads, (size_t)smem);
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
  if (smem != 4 * table_floats(m, d) || smem > kMaxSmem || blocks < 1 ||
      (int64_t)blocks * per_block < s)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_table_smem();
  if (e != cudaSuccess) return (int)e;
  scatter_cols_block_kernel<<<blocks, kBlockThreads, (size_t)smem, stream>>>(
      g, idx, part, d, m, s, per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int tn = m * d;
  combine_tables_kernel<<<(tn + 31) / 32, 32 * kCombineWarps, 0, stream>>>(
      part, dtable, tn, table_floats(m, d), blocks);
  return (int)cudaGetLastError();
}

// K4's atomic route. g: (d, s) float32; dtable: (d, m) float32, zeroed by
// the caller. Returns cudaError_t.
extern "C" int gather_small_cols_bwd_atomics(const float* g,
                                             const int32_t* idx,
                                             float* dtable, int d, int m,
                                             int64_t s, int num_sms,
                                             cudaStream_t stream) {
  int64_t blocks = (s + kThreads - 1) / kThreads;
  const int64_t cap = 8 * (int64_t)num_sms;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  scatter_cols_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      g, idx, dtable, d, m, s);
  return (int)cudaGetLastError();
}

// blocks: (2,) int32, receives the resident blocks per SM of K4's table
// kernel at `smem` bytes of dynamic shared memory and of its second pass
// (K6's) on the current device. Returns cudaError_t.
extern "C" int gather_small_cols_occupancy(int64_t smem, int* blocks) {
  cudaError_t e = allow_table_smem();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[0], scatter_cols_block_kernel, kBlockThreads, (size_t)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[1], combine_tables_kernel, 32 * kCombineWarps, 0);
  return (int)e;
}
