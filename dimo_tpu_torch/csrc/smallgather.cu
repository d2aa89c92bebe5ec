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


// K4: the gather's backward, dtable[d, idx[s]] += g[d, s] for a (D, S)
// cotangent into the (D, M) table.
//
// Replaces dimo_tpu/ops/smallgather.py:_bwd_kernel_cols (called through
// _bwd_call_cols by the custom VJP _gc_bwd), a one-hot bf16 hi+lo matmul
// on the TPU.
//
// What bounds it on the H100: bytes. At the flagship (D=11, M=512,
// S=400k) it reads 1.6 MB of indices and 17.6 MB of cotangent and writes
// a 22.5 KB table: ~5.7 us at 3.35 TB/s.
//
// Design: each block zeroes a shared-memory copy of the table, walks
// sites with a grid-stride loop (one coalesced index load and D coalesced
// cotangent loads per site) and adds into shared memory with shared
// atomics; then it adds its copy into the output (zeroed by the caller)
// with one global atomic per nonzero entry. The grid is capped at a few
// blocks per SM, so the output sees a few hundred atomics per entry, not
// one per site. An index outside [0, M) contributes nothing. Sums are
// exact float32 additions in an order that varies from run to run.
__global__ void scatter_cols_kernel(const float* __restrict__ g,
                                    const int32_t* __restrict__ idx,
                                    float* __restrict__ dtable, int d, int m,
                                    int64_t s) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < d * m; i += blockDim.x) tab[i] = 0.0f;
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t site = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       site < s; site += stride) {
    const int j = idx[site];
    if (j < 0 || j >= m) continue;
    for (int r = 0; r < d; ++r) atomicAdd(&tab[r * m + j], g[r * s + site]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d * m; i += blockDim.x) {
    const float v = tab[i];
    if (v != 0.0f) atomicAdd(&dtable[i], v);
  }
}

// K5: the same gather in ROW layout, out[s, :] = table[idx[s], :] for an
// (M, D) table, (S, D) out.
//
// Replaces dimo_tpu/ops/smallgather.py:_fwd_kernel (called through
// _fwd_call / gather_small), a one-hot bf16 hi+lo matmul on the TPU.
//
// What bounds it on the H100: bytes, as K2: at the LBS shape (M=512, D=11,
// S=400k) 1.6 MB of indices in and 17.6 MB of rows out, ~5.7 us.
//
// Design: a row of D=11 floats is 44 bytes, so a thread per row would write
// 44-byte strides. Instead consecutive threads walk the FLATTENED (S*D)
// output with a grid-stride loop: element i belongs to row i / D, column
// i % D, reads idx[row] (the ~D threads of a row hit one address, a
// broadcast) and one table value, and writes out[i]: every warp stores 128
// contiguous bytes. The table is read from device memory through the
// read-only cache, whatever its size: a small one stays in L1/L2, and a
// copy staged in each block's shared memory measured no faster at the LBS
// shape. Exact float32; an index outside [0, M) reads zeros.
__global__ void gather_rows_kernel(const float* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ out, int m, int d,
                                   int64_t s) {
  const int64_t total = s * d;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int64_t row = i / d;
    const int col = (int)(i - row * d);
    const int j = idx[row];
    out[i] = (j >= 0 && j < m) ? __ldg(table + (int64_t)j * d + col) : 0.0f;
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
// cotangent in, a 22.5 KB table out at the LBS shape, ~5.7 us.
//
// Design: threads walk the flattened (S*D) cotangent (coalesced loads) and
// add each element into the output (zeroed by the caller) with one global
// atomic, whatever the table's size. K4's block-private shared-memory
// table measured ~20% slower here at the LBS shape: consecutive threads
// add to the D consecutive floats of one row, so the atomics of a warp
// land in few cache lines and L2 resolves them. An index outside [0, M)
// adds nothing. Sums are exact float32 additions in an order that varies
// from run to run.
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

// dtable: (d, m) float32, zeroed by the caller; g: (d, s) float32.
// Returns cudaError_t.
extern "C" int gather_small_cols_bwd(const float* g, const int32_t* idx,
                                     float* dtable, int d, int m, int64_t s,
                                     int num_sms, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)d * (size_t)m;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scatter_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int64_t blocks = (s + kThreads - 1) / kThreads;
  const int64_t cap = 2 * (int64_t)num_sms;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  scatter_cols_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      g, idx, dtable, d, m, s);
  return (int)cudaGetLastError();
}

namespace {

template <typename Kernel>
int launch_rows(Kernel kernel, const float* a, const int32_t* idx, float* b,
                int m, int d, int64_t s, int blocks_per_sm, int num_sms,
                cudaStream_t stream) {
  int64_t blocks = (s * d + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)blocks_per_sm * num_sms;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(a, idx, b, m, d, s);
  return (int)cudaGetLastError();
}

}  // namespace

// table: (m, d) float32; idx: (s,) int32; out: (s, d) float32.
// Returns cudaError_t.
extern "C" int gather_small_rows_fwd(const float* table, const int32_t* idx,
                                     float* out, int m, int d, int64_t s,
                                     int num_sms, cudaStream_t stream) {
  return launch_rows(gather_rows_kernel, table, idx, out, m, d, s, 4, num_sms,
                     stream);
}

// g: (s, d) float32; dtable: (m, d) float32, zeroed by the caller.
// Returns cudaError_t.
extern "C" int gather_small_rows_bwd(const float* g, const int32_t* idx,
                                     float* dtable, int m, int d, int64_t s,
                                     int num_sms, cudaStream_t stream) {
  return launch_rows(scatter_rows_kernel, g, idx, dtable, m, d, s, 2, num_sms,
                     stream);
}
