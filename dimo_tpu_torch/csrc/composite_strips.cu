// Forward strip compositor (front-to-back alpha blending of depth-ordered
// per-strip lists), 7 channels exhaustive or 3/4 channels with early exit.
//
// Replaces dimo_tpu/ops/rasterizer/composite_strips.py:_fwd_kernel (called
// through _fwd_call by composite_strips and composite_strips_infer).
//
// What bounds it on the H100: operations. Each (pixel, list entry) pair
// costs ~14 float32 ops for the power quadratic, one exp2, a clamp, and
// 2 + 2*C for the blend; at the flagship (512^2, capacity 1024) that is a
// few GFLOP per frame against ~20 MB of table, list and image traffic, so
// the card's float32 rate, not its memory, sets the floor. The serial
// dependence through T runs along each pixel's list, never across pixels.
//
// Design: one 32x32-thread block per 32x32 strip, one thread per pixel,
// so the TPU layout (four strips packed into 128 lanes, bf16 splits and
// one-hot feature matmuls) does not carry over. The block walks its list
// in chunks of kChunk entries: the first kChunk threads each gather one
// 64-byte coefficient row by list index straight from the (N+1, 16) table
// (no per-buffer slabs), apply the home->eval Taylor shift once per entry
// (the reference's _shift_slab), and park the shifted coefficients and
// colours in shared memory; then every thread blends the chunk from
// shared memory with T and the channel sums in registers. The output is
// written once, in image layout (C+1, H_pad, W_pad), T_final last.
//
// Early exit (3/4 channels): at each chunk boundary the block votes
// (__syncthreads_or) whether any pixel still has T >= T_EXIT; if none,
// the strip stops. The entry that crosses the threshold is always
// blended, so the image differs from the exhaustive one only by a
// T_EXIT-weighted tail. The 7-channel variant never stops early.
//
// Numerics: built with --fmad=false and written in the plain version's
// op order (composite_strips_plain), so both round every product and sum
// alike; exp2f is the full-precision libdevice routine (no fast math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStrip = 32;     // strip height and width (pixels)
constexpr int kChunk = 256;    // list entries staged per shared-memory pass
constexpr int kCoefDim = 16;   // row width of the coefficient table
// coefficient-table lanes (strips.py)
constexpr int kA = 0, kB = 1, kC = 2, kD = 3, kE = 4, kF = 5, kR = 6;
constexpr int kHsc = 13, kHsr = 14;

template <int CH, bool EARLY>
__global__ void __launch_bounds__(kStrip * kStrip)
composite_fwd_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ idx,
                     const int32_t* __restrict__ count,
                     float* __restrict__ out, int32_t* __restrict__ entries,
                     int table_rows, int cs, int nrows, int ncols) {
  __shared__ float s_coef[6][kChunk];
  __shared__ float s_col[CH][kChunk];

  const float kAlphaEps = 1.0f / 255.0f;
  const float kAlphaMax = 0.99f;
  const float kTExit = 1e-4f;

  const int strip = blockIdx.x;
  const int sr = strip / ncols;
  const int sc = strip % ncols;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kStrip + tx;
  const float fsc = (float)sc;
  const float fsr = (float)sr;
  const float x = (float)(tx - kStrip / 2);   // centre-local column
  const float xx = x * x;
  const float d = (float)ty;                   // row from the strip top

  int n = count[strip];
  n = n < 0 ? 0 : (n > cs ? cs : n);
  const int32_t* list = idx + (int64_t)strip * cs;

  float T = 1.0f;
  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0.0f;

  int done = 0;
  for (int base = 0; base < n; base += kChunk) {
    if (base > 0) {
      // the barrier also guards shared memory before it is refilled
      if (EARLY) {
        if (!__syncthreads_or(T >= kTExit)) break;
      } else {
        __syncthreads();
      }
    }
    const int m = (n - base) < kChunk ? (n - base) : kChunk;
    if (tid < m) {
      int gi = list[base + tid];
      if (gi < 0 || gi >= table_rows) gi = table_rows - 1;  // dummy row
      const float4* row =
          reinterpret_cast<const float4*>(table + (int64_t)gi * kCoefDim);
      float r[kCoefDim];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v4 = row[q];
        r[4 * q + 0] = v4.x;
        r[4 * q + 1] = v4.y;
        r[4 * q + 2] = v4.z;
        r[4 * q + 3] = v4.w;
      }
      // home -> eval frame: (u, v) = 32 * (eval - home)
      const float u = 32.0f * (fsc - r[kHsc]);
      const float v = 32.0f * (fsr - r[kHsr]);
      const float cA = r[kA], cB = r[kB], cC = r[kC];
      const float cD = r[kD], cE = r[kE], cF = r[kF];
      s_coef[0][tid] = cA;
      s_coef[1][tid] = cB;
      s_coef[2][tid] = cC;
      s_coef[3][tid] = (cD + (2.0f * u) * cA) + v * cB;
      s_coef[4][tid] = (cE + (2.0f * v) * cC) + u * cB;
      s_coef[5][tid] = ((((cF + (u * u) * cA) + (u * v) * cB) + (v * v) * cC)
                        + u * cD) + v * cE;
#pragma unroll
      for (int c = 0; c < CH; ++c) s_col[c][tid] = r[kR + c];
    }
    __syncthreads();
    for (int e = 0; e < m; ++e) {
      const float cA = s_coef[0][e], cB = s_coef[1][e], cC = s_coef[2][e];
      const float cD = s_coef[3][e], cE = s_coef[4][e], cF = s_coef[5][e];
      const float x0 = (cA * xx + cD * x) + cF;
      const float x1 = cB * x + cE;
      const float A = (x0 - 16.0f * x1) + 256.0f * cC;
      const float B = x1 - 32.0f * cC;
      const float p = A + d * (B + d * cC);
      const float ar = exp2f(p);
      const float a = (ar >= kAlphaEps) ? fminf(ar, kAlphaMax) : 0.0f;
      const float w = a * T;
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[c] = acc[c] + s_col[c][e] * w;
      T = T - w;
    }
    done = base + m;
  }

  const int64_t height = (int64_t)nrows * kStrip;
  const int64_t width = (int64_t)ncols * kStrip;
  const int64_t pix = (int64_t)(sr * kStrip + ty) * width + sc * kStrip + tx;
#pragma unroll
  for (int c = 0; c < CH; ++c) out[c * height * width + pix] = acc[c];
  out[CH * height * width + pix] = T;
  if (entries != nullptr && tid == 0) entries[strip] = done;
}

template <int CH, bool EARLY>
int launch(const float* table, const int32_t* idx, const int32_t* count,
           float* out, int32_t* entries, int table_rows, int cs, int nrows,
           int ncols, cudaStream_t stream) {
  const dim3 block(kStrip, kStrip);
  composite_fwd_kernel<CH, EARLY><<<nrows * ncols, block, 0, stream>>>(
      table, idx, count, out, entries, table_rows, cs, nrows, ncols);
  return (int)cudaGetLastError();
}

}  // namespace

// out: (out_ch + 1, nrows*32, ncols*32) float32; entries: optional (Ns,)
// int32 count of list entries each strip composited. out_ch 7 composites
// every entry; out_ch 3 or 4 exits early. Returns cudaError_t.
extern "C" int composite_strips_fwd(const float* table, const int32_t* idx,
                                    const int32_t* count, float* out,
                                    int32_t* entries, int table_rows, int cs,
                                    int nrows, int ncols, int out_ch,
                                    cudaStream_t stream) {
  if (nrows * ncols == 0) return 0;
  switch (out_ch) {
    case 7:
      return launch<7, false>(table, idx, count, out, entries, table_rows,
                              cs, nrows, ncols, stream);
    case 4:
      return launch<4, true>(table, idx, count, out, entries, table_rows, cs,
                             nrows, ncols, stream);
    case 3:
      return launch<3, true>(table, idx, count, out, entries, table_rows, cs,
                             nrows, ncols, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
