// Strip compositor: kernel K1, the forward (front-to-back alpha blending of
// depth-ordered per-strip lists, 7 channels exhaustive or 3/4 channels with
// early exit), and kernel K3, the 7-channel composite's VJP.
//
// K1 replaces dimo_tpu/ops/rasterizer/composite_strips.py:_fwd_kernel
// (called through _fwd_call by composite_strips and
// composite_strips_infer); K3 replaces its _bwd_kernel (called through
// _bwd_call by the custom VJP _cs_bwd). K3 is described above its kernel.
//
// K1:
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
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;

// Home -> eval frame: the Taylor shift of a row's power quadratic by
// (u, v) = 32 * (eval - home). r is the 16-lane row; writes the six
// eval-frame coefficients. Shared by K1 and K3, so both see the same bits.
__device__ __forceinline__ void shift_row(const float* r, float fsc, float fsr,
                                          float* c6, float* u_out,
                                          float* v_out) {
  const float u = 32.0f * (fsc - r[kHsc]);
  const float v = 32.0f * (fsr - r[kHsr]);
  const float cA = r[kA], cB = r[kB], cC = r[kC];
  const float cD = r[kD], cE = r[kE], cF = r[kF];
  c6[0] = cA;
  c6[1] = cB;
  c6[2] = cC;
  c6[3] = (cD + (2.0f * u) * cA) + v * cB;
  c6[4] = (cE + (2.0f * v) * cC) + u * cB;
  c6[5] = ((((cF + (u * u) * cA) + (u * v) * cB) + (v * v) * cC) + u * cD)
          + v * cE;
  *u_out = u;
  *v_out = v;
}

// Load row gi of the (rows, 16) table; an index outside it reads the
// dummy (last) row.
__device__ __forceinline__ void load_row(const float* table, int gi,
                                         int table_rows, float* r) {
  if (gi < 0 || gi >= table_rows) gi = table_rows - 1;
  const float4* row =
      reinterpret_cast<const float4*>(table + (int64_t)gi * kCoefDim);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v4 = row[q];
    r[4 * q + 0] = v4.x;
    r[4 * q + 1] = v4.y;
    r[4 * q + 2] = v4.z;
    r[4 * q + 3] = v4.w;
  }
}

// alpha of eval-frame coefficients c6 at centre-local column x (xx = x*x)
// and row d from the strip top, in composite_strips_plain's op order;
// *araw receives exp2(power) before the cut and the cap. K1 and K3 both
// call this, so K3 replays K1's alpha bit for bit.
__device__ __forceinline__ float entry_alpha(const float* c6, float x,
                                             float xx, float d,
                                             float* araw) {
  const float x0 = (c6[0] * xx + c6[3] * x) + c6[5];
  const float x1 = c6[1] * x + c6[4];
  const float A = (x0 - 16.0f * x1) + 256.0f * c6[2];
  const float B = x1 - 32.0f * c6[2];
  const float p = A + d * (B + d * c6[2]);
  const float ar = exp2f(p);
  *araw = ar;
  return (ar >= kAlphaEps) ? fminf(ar, kAlphaMax) : 0.0f;
}

template <int CH, bool EARLY>
__global__ void __launch_bounds__(kStrip * kStrip)
composite_fwd_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ idx,
                     const int32_t* __restrict__ count,
                     float* __restrict__ out, int32_t* __restrict__ entries,
                     int table_rows, int cs, int nrows, int ncols) {
  __shared__ float s_coef[6][kChunk];
  __shared__ float s_col[CH][kChunk];

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
      float r[kCoefDim], c6[6], u, v;
      load_row(table, list[base + tid], table_rows, r);
      shift_row(r, fsc, fsr, c6, &u, &v);
#pragma unroll
      for (int k = 0; k < 6; ++k) s_coef[k][tid] = c6[k];
#pragma unroll
      for (int c = 0; c < CH; ++c) s_col[c][tid] = r[kR + c];
    }
    __syncthreads();
    for (int e = 0; e < m; ++e) {
      const float c6[6] = {s_coef[0][e], s_coef[1][e], s_coef[2][e],
                           s_coef[3][e], s_coef[4][e], s_coef[5][e]};
      float ar;
      const float a = entry_alpha(c6, x, xx, d, &ar);
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


// K3: the 7-channel composite's VJP, per list slot.
//
// What bounds it on the H100: operations. Per (pixel, list entry) pair it
// replays alpha (~19 ops with the exp2), rebuilds T by one division, forms
// the channel-weighted cotangent sum (13), dalpha, the suffix update and
// dpower (~10), and feeds ten per-pixel terms into sums over the strip
// (~20): ~65 float32 ops, against ~35 MB of table rows, cotangent and
// per-slot output at the flagship, so the float32 rate sets the floor.
//
// Design: one 32x32-thread block per strip, one thread per pixel, as K1.
// The block walks its list BACK TO FRONT in chunks of kBwdChunk entries;
// one thread per entry loads its table row, applies the Taylor shift
// (shift_row, K1's), and parks the eval-frame coefficients, the colours
// and (u, v) in shared memory. Each thread starts from the forward's
// T_final and the suffix gs = g_T * T_final, and per entry:
//   a = entry_alpha(...)             (K1's function: the same bits)
//   T = T * (1 / (1 - a))            (T in front of the entry)
//   CG = sum_ch gout_ch * c_ch;  dalpha = CG*T - gs/(1-a);  gs += CG*a*T
//   dpow = [1/255 <= araw < 0.99] * dalpha * araw * ln2
// Each warp is one pixel row (fixed y), so the six eval-frame moment sums
// (x^2, xy, y^2, x, y, 1 times dpow) factor into three per-row sums
// (dpow, dpow*x, dpow*x^2); with the seven colour sums (w * gout_ch) that
// is ten values, reduced across the warp by xor shuffles and parked per
// (row, entry) in shared memory. After the chunk, threads sum the 32 rows
// with weights 1, y, y^2 into the thirteen per-entry grads, chain the six
// coefficient grads back through the Taylor shift (the reference's
// _unshift_grad) and write each slot's 16 lanes (ids 0). Slots past the
// strip's count are written as zeros. No early stop, no atomics: the
// output is per slot, and gather_rows' backward adds slots into the table.
constexpr int kBwdChunk = 32;
constexpr int kRowSums = 10;   // dpow, dpow*x, dpow*x^2, w*g_0..w*g_6
constexpr int kOutCh = 7;
constexpr float kLn2 = 0.6931471805599453f;

__global__ void __launch_bounds__(kStrip * kStrip)
composite_bwd_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ idx,
                     const int32_t* __restrict__ count,
                     const float* __restrict__ tfin,
                     const float* __restrict__ gout,
                     float* __restrict__ dslot, int table_rows, int cs,
                     int nrows, int ncols) {
  __shared__ float s_coef[6][kBwdChunk];
  __shared__ float s_col[kOutCh][kBwdChunk];
  __shared__ float s_uv[2][kBwdChunk];
  __shared__ float s_part[kStrip][kBwdChunk][kRowSums];
  __shared__ float s_red[kBwdChunk][6 + kOutCh];

  const int strip = blockIdx.x;
  const int sr = strip / ncols;
  const int sc = strip % ncols;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kStrip + tx;
  const float fsc = (float)sc;
  const float fsr = (float)sr;
  const float x = (float)(tx - kStrip / 2);
  const float xx = x * x;
  const float d = (float)ty;

  int n = count[strip];
  n = n < 0 ? 0 : (n > cs ? cs : n);
  const int32_t* list = idx + (int64_t)strip * cs;
  float* out = dslot + (int64_t)strip * cs * kCoefDim;
  for (int i = n * kCoefDim + tid; i < cs * kCoefDim; i += kStrip * kStrip)
    out[i] = 0.0f;

  const int64_t plane = (int64_t)nrows * kStrip * ncols * kStrip;
  const int64_t width = (int64_t)ncols * kStrip;
  const int64_t pix = (int64_t)(sr * kStrip + ty) * width + sc * kStrip + tx;
  float g[kOutCh];
#pragma unroll
  for (int c = 0; c < kOutCh; ++c) g[c] = gout[c * plane + pix];
  float T = tfin[pix];
  float gs = gout[kOutCh * plane + pix] * T;

  for (int base = ((n - 1) / kBwdChunk) * kBwdChunk; n > 0 && base >= 0;
       base -= kBwdChunk) {
    const int m = (n - base) < kBwdChunk ? (n - base) : kBwdChunk;
    __syncthreads();   // the previous chunk's readers are done
    if (tid < m) {
      float r[kCoefDim], c6[6], u, v;
      load_row(table, list[base + tid], table_rows, r);
      shift_row(r, fsc, fsr, c6, &u, &v);
#pragma unroll
      for (int k = 0; k < 6; ++k) s_coef[k][tid] = c6[k];
#pragma unroll
      for (int c = 0; c < kOutCh; ++c) s_col[c][tid] = r[kR + c];
      s_uv[0][tid] = u;
      s_uv[1][tid] = v;
    }
    __syncthreads();
    for (int e = m - 1; e >= 0; --e) {
      const float c6[6] = {s_coef[0][e], s_coef[1][e], s_coef[2][e],
                           s_coef[3][e], s_coef[4][e], s_coef[5][e]};
      float ar;
      const float a = entry_alpha(c6, x, xx, d, &ar);
      const float inv = 1.0f / (1.0f - a);
      T = T * inv;
      const float w = a * T;
      float cg = g[0] * s_col[0][e];
#pragma unroll
      for (int c = 1; c < kOutCh; ++c) cg = cg + g[c] * s_col[c][e];
      const float dalpha = cg * T - gs * inv;
      gs = gs + cg * w;
      const bool gate = (ar >= kAlphaEps) && (ar < kAlphaMax);
      const float dpow = ((gate ? dalpha : 0.0f) * ar) * kLn2;
      float v[kRowSums];
      v[0] = dpow;
      v[1] = dpow * x;
      v[2] = dpow * xx;
#pragma unroll
      for (int c = 0; c < kOutCh; ++c) v[3 + c] = w * g[c];
#pragma unroll
      for (int off = kStrip / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < kRowSums; ++q)
          v[q] += __shfl_xor_sync(0xffffffffu, v[q], off);
      }
#pragma unroll
      for (int q = 0; q < kRowSums; ++q)
        if (tx == q) s_part[ty][e][q] = v[q];
    }
    __syncthreads();
    // per entry: dA = sum S2, dB = sum y*S1, dC = sum y^2*S0, dD = sum S1,
    // dE = sum y*S0, dF = sum S0 over rows (y = row - 16); colours sum C_c
    for (int t = tid; t < m * (6 + kOutCh); t += kStrip * kStrip) {
      const int e = t / (6 + kOutCh);
      const int k = t % (6 + kOutCh);
      const int src = k < 6 ? (k == 0 ? 2 : (k == 1 || k == 3) ? 1 : 0)
                            : 3 + (k - 6);
      const int pw = (k == 2) ? 2 : (k == 1 || k == 4) ? 1 : 0;
      float acc = 0.0f;
      for (int rr = 0; rr < kStrip; ++rr) {
        const float y = (float)(rr - kStrip / 2);
        const float wt = pw == 0 ? 1.0f : (pw == 1 ? y : y * y);
        acc = acc + wt * s_part[rr][e][src];
      }
      s_red[e][k] = acc;
    }
    __syncthreads();
    for (int t = tid; t < m * kCoefDim; t += kStrip * kStrip) {
      const int e = t / kCoefDim;
      const int lane = t % kCoefDim;
      const float u = s_uv[0][e], v = s_uv[1][e];
      const float dA = s_red[e][0], dB = s_red[e][1], dC = s_red[e][2];
      const float dD = s_red[e][3], dE = s_red[e][4], dF = s_red[e][5];
      float val = 0.0f;
      switch (lane) {
        case kA: val = (dA + (2.0f * u) * dD) + (u * u) * dF; break;
        case kB: val = ((dB + v * dD) + u * dE) + (u * v) * dF; break;
        case kC: val = (dC + (2.0f * v) * dE) + (v * v) * dF; break;
        case kD: val = dD + u * dF; break;
        case kE: val = dE + v * dF; break;
        case kF: val = dF; break;
        default: val = lane < kR + kOutCh ? s_red[e][lane] : 0.0f;
      }
      out[(int64_t)(base + e) * kCoefDim + lane] = val;
    }
  }
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

// dslot: (Ns, cs, 16) float32 per-slot home-frame row grads of the
// 7-channel composite, given the forward's T_final tfin (H, W) and the
// cotangent gout (8, H, W) of its 7 channels and T_final. Returns
// cudaError_t.
extern "C" int composite_strips_bwd(const float* table, const int32_t* idx,
                                    const int32_t* count, const float* tfin,
                                    const float* gout, float* dslot,
                                    int table_rows, int cs, int nrows,
                                    int ncols, cudaStream_t stream) {
  if (nrows * ncols == 0) return 0;
  const dim3 block(kStrip, kStrip);
  composite_bwd_kernel<<<nrows * ncols, block, 0, stream>>>(
      table, idx, count, tfin, gout, dslot, table_rows, cs, nrows, ncols);
  return (int)cudaGetLastError();
}
