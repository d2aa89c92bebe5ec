// Window readout of the binning's sorted pair array (kernel K7):
// out[t, j] = pairs[starts[t] + j] for j < capacity, (0, 0) where
// starts[t] + j >= ND.
//
// Replaces dimo_tpu/ops/rasterizer/windowdma.py:_kernel (called through
// gather_windows), which the TPU ran as one contiguous DMA of 8 * capacity
// bytes per bin out of a zero-padded copy of the array.
//
// What bounds it on the H100: bytes, and so few of them that the launch
// dominates. At the flagship (T = 256 bins, capacity 1024) it reads 2 MiB
// of (key, val) rows and writes 2 MiB: ~1.3 us at 3.35 TB/s against a
// launch of several microseconds.
//
// Design: blockIdx.y is the bin, blockIdx.x a chunk of 256 rows of its
// window; a thread copies one 8-byte row as an int2 (rows are 8-byte
// aligned at any start because the array is (ND, 2) int32), so a warp
// moves 256 contiguous bytes in and out. The bound check against ND stands
// in for the reference's zero padding, so no padded copy of the array is
// made. The TPU kernel's burst of DMAs in flight has no counterpart: all
// blocks are in flight at once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_windows_kernel(const int2* __restrict__ pairs,
                                      const int32_t* __restrict__ starts,
                                      int2* __restrict__ out, int nd,
                                      int capacity) {
  const int t = blockIdx.y;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= capacity) return;
  const int64_t src = (int64_t)starts[t] + j;
  int2 row = make_int2(0, 0);
  if (src >= 0 && src < nd) row = pairs[src];
  out[(int64_t)t * capacity + j] = row;
}

}  // namespace

// pairs: (nd, 2) int32; starts: (t,) int32; out: (t, capacity, 2) int32.
// Returns cudaError_t.
extern "C" int gather_windows(const int32_t* pairs, const int32_t* starts,
                              int32_t* out, int nd, int t, int capacity,
                              cudaStream_t stream) {
  if (t <= 0 || capacity <= 0) return 0;
  if (t > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((capacity + kThreads - 1) / kThreads, t);
  gather_windows_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const int2*>(pairs), starts,
      reinterpret_cast<int2*>(out), nd, capacity);
  return (int)cudaGetLastError();
}
