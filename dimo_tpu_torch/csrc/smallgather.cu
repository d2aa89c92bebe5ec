// LBS column gather (kernel K2): out[d, s] = table[d, idx[s]] for a small
// (D, M) table, and its transpose (kernel K4, described above its kernel):
// dtable[d, idx[s]] += g[d, s].
//
// K2 replaces dimo_tpu/ops/smallgather.py:_fwd_kernel_cols (called through
// _fwd_call_cols / gather_small_cols), which the TPU ran as a one-hot
// bf16 hi+lo matmul because XLA's gather serialises rows there.
//
// What bounds it on the H100: bytes. At the flagship (D=11, M=512,
// S=K*N=400k) the kernel reads 1.6 MB of indices and writes 17.6 MB of
// output, against a 22.5 KB table; at 3.35 TB/s that is ~5.8 us. There is
// no arithmetic to speak of.
//
// Design: each block stages the whole table in shared memory once (11*M
// floats, 22.5 KB at M=512, 45 KB at M=1024), then walks sites with a
// grid-stride loop, one site per thread per step. A thread reads its
// index with one coalesced 4-byte load and writes its D values as D
// coalesced row stores (row d of the output is contiguous over sites), so
// device memory sees only the index read and the output write. The grid
// is capped at a few blocks per SM so the table is staged ~500 times, not
// once per 256 sites. The gather is exact (no bf16 split); an index
// outside [0, M) reads zeros, as the TPU kernel's one-hot does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_cols_kernel(const float* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ out,
                                   int d, int m, int64_t s) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < d * m; i += blockDim.x) tab[i] = table[i];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t site = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       site < s; site += stride) {
    const int j = idx[site];
    const bool ok = (j >= 0) && (j < m);
    for (int r = 0; r < d; ++r) out[r * s + site] = ok ? tab[r * m + j] : 0.0f;
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

}  // namespace

extern "C" int gather_small_cols_fwd(const float* table, const int32_t* idx,
                                     float* out, int d, int m, int64_t s,
                                     int num_sms, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)d * (size_t)m;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gather_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int64_t blocks = (s + kThreads - 1) / kThreads;
  const int64_t cap = 4 * (int64_t)num_sms;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  gather_cols_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      table, idx, out, d, m, s);
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
