// Window readout of the binning's sorted pair array (kernel K7):
// out[t, j] = pairs[starts[t] + j] for j < capacity, (0, 0) where
// starts[t] + j >= ND.
//
// Replaces dimo_tpu/ops/rasterizer/windowdma.py:_kernel (called through
// gather_windows), which the TPU ran as one contiguous DMA of 8 * capacity
// bytes per bin out of a zero-padded copy of the array.
//
// What bounds it on the H100: bytes, and so few of them that the launch
// and one round trip to memory are most of it. At the flagship (T = 256
// bins, capacity 1024) it reads 2 MiB of (key, val) rows and writes 2 MiB:
// 1.25 us at 3.35 TB/s, next to the launch itself (below).
//
// Design: one block of 512 threads per (bin, chunk of 1,024 rows), 256
// blocks at the flagship, one wave. The block's window start is one
// uniform load held in a register. Each thread moves two rows and issues
// its loads before its store. With an even capacity the rows go as a pair:
// one 16-byte int4 store (the output pair is 16-byte aligned because
// t * capacity is even), so a warp stores 512 contiguous bytes; the pair is
// one int4 load when the window's source is 16-byte aligned (an even
// start), else two int2 loads. An odd capacity takes the scalar path of the
// same kernel: rows i and i + 512 of the chunk as int2. Rows at or past ND
// read zeros: the bound check stands in for the reference's zero padding,
// so no padded copy of the array is made.
//
// Measured in a CUDA graph on NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py,
// PERF.md, Findings), in turns: 2.00 us against 2.09-2.10 for the design it
// replaced (1,024 blocks of 256 threads, a thread per row, every thread
// loading starts[t]). Four or eight rows a thread took 2.10-2.11; two rows
// a thread 2.02-2.05 in blocks of 128, 256 or 512. All starts even read
// 1.97-1.98 us, all odd 2.01-2.02. The launch floor, a one-element add_,
// takes 1.21-1.22 us.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 2 * kThreads;        // rows per block, two a thread

__device__ __forceinline__ int2 row_at(const int2* __restrict__ pairs,
                                       int64_t src, int nd) {
  return (src >= 0 && src < nd) ? __ldg(pairs + src) : make_int2(0, 0);
}

__global__ void __launch_bounds__(kThreads)
gather_windows_kernel(const int2* __restrict__ pairs,
                      const int32_t* __restrict__ starts,
                      int2* __restrict__ out, int nd, int capacity,
                      bool pair_store) {
  const int t = blockIdx.x;
  const int c0 = blockIdx.y * kChunk;
  const int n = min(kChunk, capacity - c0);          // rows of this chunk
  const int64_t src0 = (int64_t)__ldg(starts + t) + c0;
  int2* dst = out + (int64_t)t * capacity + c0;
  if (pair_store) {
    const int r = 2 * threadIdx.x;
    if (r >= n) return;
    const int64_t src = src0 + r;
    int4 w;
    if ((reinterpret_cast<uintptr_t>(pairs + src) & 15) == 0 && src >= 0 &&
        src + 1 < nd) {
      w = __ldg(reinterpret_cast<const int4*>(pairs + src));
    } else {
      const int2 a = row_at(pairs, src, nd);
      const int2 b = row_at(pairs, src + 1, nd);
      w = make_int4(a.x, a.y, b.x, b.y);
    }
    *reinterpret_cast<int4*>(dst + r) = w;
    return;
  }
  const int r0 = threadIdx.x, r1 = threadIdx.x + kThreads;
  const int2 a = r0 < n ? row_at(pairs, src0 + r0, nd) : make_int2(0, 0);
  const int2 b = r1 < n ? row_at(pairs, src0 + r1, nd) : make_int2(0, 0);
  if (r0 < n) dst[r0] = a;
  if (r1 < n) dst[r1] = b;
}

}  // namespace

// pairs: (nd, 2) int32, 8-byte aligned; starts: (t,) int32; out:
// (t, capacity, 2) int32. Returns cudaError_t.
extern "C" int gather_windows(const int32_t* pairs, const int32_t* starts,
                              int32_t* out, int nd, int t, int capacity,
                              cudaStream_t stream) {
  if (t <= 0 || capacity <= 0) return 0;
  const int chunks = (capacity + kChunk - 1) / kChunk;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const bool pair_store = capacity % 2 == 0 &&
                          (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  gather_windows_kernel<<<dim3(t, chunks), kThreads, 0, stream>>>(
      reinterpret_cast<const int2*>(pairs), starts,
      reinterpret_cast<int2*>(out), nd, capacity, pair_store);
  return (int)cudaGetLastError();
}
