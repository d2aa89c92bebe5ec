// Strip compositor: kernel K1, the forward (front-to-back alpha blending of
// depth-ordered per-strip lists, 7 channels exhaustive or 3/4 channels with
// early exit), and kernel K3, the 7-channel composite's VJP.
//
// K1 replaces dimo_tpu/ops/rasterizer/composite_strips.py:_fwd_kernel
// (called through _fwd_call by composite_strips and
// composite_strips_infer); K3 replaces its _bwd_kernel (called through
// _bwd_call by the custom VJP _cs_bwd). K3 is described above its kernel.
//
// Work layout, shared by K1 and K3: a strip's 32 rows are cut into row
// groups and each block takes one (strip, group), so a 512^2 frame is
// several blocks per SM in one wave instead of two waves of one
// 1,024-thread block. A thread owns kRows consecutive pixel rows of one
// column: it forms an entry's column terms once (entry_columns) and
// evaluates the power p = A + d * (B + d * C) for each of its rows
// (entry_power), in composite_strips_plain's op order. A warp covers 16
// columns x 8 rows. exp2f(p) < 2^-8 < 1/255 for p < kPowerCut,
// so a pair with such a power has alpha exactly 0 and changes nothing in
// either kernel: a thread (K1) or a warp (K3) whose rows all lie below the
// cut skips the entry after forming p.
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
// Design: the block walks its strip's list in chunks of one entry per
// thread: each thread gathers one 64-byte coefficient row by list index
// straight from the (N+1, 16) table, applies the home->eval Taylor shift
// once per entry (the reference's _shift_slab) and parks the shifted
// coefficients and colours in shared memory as float4s; then every thread
// blends the chunk with T and the channel sums of its rows in registers.
// The output is written once, in image layout (C+1, H_pad, W_pad),
// T_final last.
//
// Early exit (3/4 channels): at each chunk boundary the block votes
// (__syncthreads_or) whether any of its pixels still has T >= T_EXIT; if
// none, the group stops, so an opaque part of a strip stops on its own.
// The entry that crosses the threshold is always blended, so the image
// differs from the exhaustive one only by a T_EXIT-weighted tail. The
// 7-channel variant never stops early. `entries` receives, per strip, the
// most entries any of its groups walked (atomicMax on a zeroed array).
//
// Numerics: built with --fmad=false and written in the plain version's
// op order (composite_strips_plain), so both round every product and sum
// alike; exp2f is the full-precision libdevice routine (no fast math).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; the flagship
// frame: 512^2, capacity 1024, 161,896 list entries, 7.7% of the
// pixel-entry pairs with alpha > 0), device time in a CUDA graph: K1 ch7
// 0.184 ms, ch3 0.154, K3 0.49, against 0.452 / 0.326 / 2.659 for the
// one-1,024-thread-block-per-strip design they replaced, timed in turns in
// the same run. Bounds (float32 ops at 67 TFLOP/s, the power at every
// pair and the rest at pairs with alpha > 0): K1 ch7 0.043 ms, ch3 0.040,
// K3 0.049. PERF.md keeps the runs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStrip = 32;     // strip height and width (pixels)
constexpr int kRows = 4;       // pixel rows a thread owns, in one column
constexpr int kCoefDim = 16;   // row width of the coefficient table
// coefficient-table lanes (strips.py)
constexpr int kA = 0, kB = 1, kC = 2, kD = 3, kE = 4, kF = 5, kR = 6;
constexpr int kHsc = 13, kHsr = 14;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
// below this power exp2f gives < 2^-8 < kAlphaEps: alpha is exactly 0
constexpr float kPowerCut = -8.0f;
constexpr unsigned kFull = 0xffffffffu;
// the work layout (composite_strips.py: ROWS_PER_THREAD, GROUP_ROWS)
constexpr int kGroupRows = 8;                      // rows of a row group
constexpr int kGroups = kStrip / kGroupRows;       // blocks per strip
constexpr int kThreads = kStrip * kGroupRows / kRows;   // 64: two warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;   // list entries staged per pass
// a warp covers kWarpCols columns x (32 / kWarpCols) * kRows rows, the
// squarest band of a row group, so that it lies below the cut more often
constexpr int kWarpCols = 16;
static_assert((kGroupRows / kRows) % (32 / kWarpCols) == 0,
              "a row group holds whole warps");

// The pixel column and the first of the kRows rows (from the strip top) of
// thread tid of a block of row group `group`.
__device__ __forceinline__ void thread_pixels(int tid, int group, int* col,
                                              int* row0) {
  constexpr int kSide = kStrip / kWarpCols;     // warps side by side
  constexpr int kDeep = 32 / kWarpCols;         // row threads in a warp
  const int lane = tid % 32, warp = tid / 32;
  *col = (warp % kSide) * kWarpCols + lane % kWarpCols;
  *row0 = group * kGroupRows
          + ((warp / kSide) * kDeep + lane / kWarpCols) * kRows;
}

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

// An entry's power along one pixel column: p(d) = A + d * (B + d * C) at
// row d from the strip top, A and B the plain version's Horner terms.
struct Columns {
  float A, B, C;
};

// The column terms of eval-frame coefficients c6 at centre-local column x
// (xx = x * x), in composite_strips_plain's op order.
__device__ __forceinline__ Columns entry_columns(const float* c6, float x,
                                                 float xx) {
  const float x0 = (c6[0] * xx + c6[3] * x) + c6[5];
  const float x1 = c6[1] * x + c6[4];
  Columns k;
  k.A = (x0 - 16.0f * x1) + 256.0f * c6[2];
  k.B = x1 - 32.0f * c6[2];
  k.C = c6[2];
  return k;
}

__device__ __forceinline__ float entry_power(const Columns& k, float d) {
  return k.A + d * (k.B + d * k.C);
}

// alpha of power p; *araw receives exp2(p) before the cut and the cap. K1
// and K3 both reach alpha through entry_columns, entry_power and this, so
// K3 replays K1's alpha bit for bit.
__device__ __forceinline__ float entry_alpha(float p, float* araw) {
  const float ar = exp2f(p);
  *araw = ar;
  return (ar >= kAlphaEps) ? fminf(ar, kAlphaMax) : 0.0f;
}

template <int CH, bool EARLY>
__global__ void __launch_bounds__(kThreads)
composite_fwd_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ idx,
                     const int32_t* __restrict__ count,
                     float* __restrict__ out, int32_t* __restrict__ entries,
                     int table_rows, int cs, int nrows, int ncols) {
  constexpr int kQuads = (CH + 3) / 4;
  __shared__ float4 s_coef[2][kChunk];   // cA cB cC cD | cE cF - -
  __shared__ float4 s_col[kQuads][kChunk];

  const float kTExit = 1e-4f;

  const int strip = blockIdx.x / kGroups;
  const int group = blockIdx.x % kGroups;
  const int sr = strip / ncols;
  const int sc = strip % ncols;
  const int tid = threadIdx.x;
  int tx, row0;
  thread_pixels(tid, group, &tx, &row0);
  const float fsc = (float)sc;
  const float fsr = (float)sr;
  const float x = (float)(tx - kStrip / 2);   // centre-local column
  const float xx = x * x;
  float d[kRows];                             // rows from the strip top
#pragma unroll
  for (int r = 0; r < kRows; ++r) d[r] = (float)(row0 + r);

  int n = count[strip];
  n = n < 0 ? 0 : (n > cs ? cs : n);
  const int32_t* list = idx + (int64_t)strip * cs;

  float T[kRows];
  float acc[CH][kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    T[r] = 1.0f;
#pragma unroll
    for (int c = 0; c < CH; ++c) acc[c][r] = 0.0f;
  }

  int done = 0;
  for (int base = 0; base < n; base += kChunk) {
    if (base > 0) {
      // the barrier also guards shared memory before it is refilled
      if (EARLY) {
        bool open = false;
#pragma unroll
        for (int r = 0; r < kRows; ++r) open = open || (T[r] >= kTExit);
        if (!__syncthreads_or(open)) break;
      } else {
        __syncthreads();
      }
    }
    const int m = (n - base) < kChunk ? (n - base) : kChunk;
    if (tid < m) {
      float r[kCoefDim], c6[6], u, v;
      load_row(table, list[base + tid], table_rows, r);
      shift_row(r, fsc, fsr, c6, &u, &v);
      s_coef[0][tid] = make_float4(c6[0], c6[1], c6[2], c6[3]);
      s_coef[1][tid] = make_float4(c6[4], c6[5], 0.0f, 0.0f);
      float cl[4 * kQuads];
#pragma unroll
      for (int c = 0; c < 4 * kQuads; ++c) cl[c] = c < CH ? r[kR + c] : 0.0f;
#pragma unroll
      for (int q = 0; q < kQuads; ++q)
        s_col[q][tid] = make_float4(cl[4 * q], cl[4 * q + 1], cl[4 * q + 2],
                                    cl[4 * q + 3]);
    }
    __syncthreads();
    for (int e = 0; e < m; ++e) {
      const float4 q0 = s_coef[0][e];
      const float4 q1 = s_coef[1][e];
      const float c6[6] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y};
      const Columns k = entry_columns(c6, x, xx);
      float p[kRows];
      bool live = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        p[r] = entry_power(k, d[r]);
        live = live || (p[r] >= kPowerCut);
      }
      if (!live) continue;
      float col[4 * kQuads];
#pragma unroll
      for (int q = 0; q < kQuads; ++q) {
        const float4 c4 = s_col[q][e];
        col[4 * q] = c4.x;
        col[4 * q + 1] = c4.y;
        col[4 * q + 2] = c4.z;
        col[4 * q + 3] = c4.w;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float ar;
        const float a = entry_alpha(p[r], &ar);
        const float w = a * T[r];
#pragma unroll
        for (int c = 0; c < CH; ++c) acc[c][r] = acc[c][r] + col[c] * w;
        T[r] = T[r] - w;
      }
    }
    done = base + m;
  }

  const int64_t height = (int64_t)nrows * kStrip;
  const int64_t width = (int64_t)ncols * kStrip;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t pix = (int64_t)(sr * kStrip + row0 + r) * width
                        + sc * kStrip + tx;
#pragma unroll
    for (int c = 0; c < CH; ++c) out[c * height * width + pix] = acc[c][r];
    out[CH * height * width + pix] = T[r];
  }
  if (entries != nullptr && tid == 0) atomicMax(entries + strip, done);
}

template <int CH, bool EARLY>
int launch_fwd(const float* table, const int32_t* idx, const int32_t* count,
               float* out, int32_t* entries, int table_rows, int cs,
               int nrows, int ncols, cudaStream_t stream) {
  composite_fwd_kernel<CH, EARLY><<<nrows * ncols * kGroups, kThreads, 0,
                                    stream>>>(
      table, idx, count, out, entries, table_rows, cs, nrows, ncols);
  return (int)cudaGetLastError();
}


// K3: the 7-channel composite's VJP, per list slot.
//
// What bounds it on the H100: operations. Per (pixel, list entry) pair it
// replays alpha (~19 ops with the exp2), rebuilds T by one division, forms
// the channel-weighted cotangent sum (13), dalpha, the suffix update and
// dpower (~10), and feeds thirteen per-pixel terms into sums over the
// strip (~20): ~65 float32 ops, against ~35 MB of table rows, cotangent
// and per-slot output at the flagship, so the float32 rate sets the floor.
//
// Design: the work layout above; each (strip, group) block walks the list
// BACK TO FRONT in chunks of one entry per thread; a thread loads its
// entry's table row, applies the Taylor shift (shift_row, K1's) and parks
// the eval-frame coefficients, (u, v) and the colours in shared memory.
// Each thread starts from the forward's T_final and the suffix
// gs = g_T * T_final of its rows, and per entry and row:
//   a = entry_alpha(...)             (K1's functions: the same bits)
//   T = T * (1 / (1 - a))            (T in front of the entry)
//   CG = sum_ch gout_ch * c_ch;  dalpha = CG*T - gs/(1-a);  gs += CG*a*T
//   dpow = [1/255 <= araw < 0.99] * dalpha * araw * ln2
// The thread sums its rows (fixed x) into S0 = sum dpow, S1 = sum dpow*y,
// S2 = sum dpow*y^2 and the colour sums sum w*gout_ch, so its share of the
// six eval-frame moments is (x^2 S0, x S1, S2, x S0, S1, S0): thirteen
// values for four pixels, summed over the warp by five xor-shuffle levels
// each (13 independent chains) and parked per (warp, entry) in shared
// memory. A reduce-scatter butterfly (16 shuffles and 30 selects an entry,
// but five dependent levels) measured 1.49x slower in turns and is not
// used. After the chunk, one thread per entry adds the warps in order,
// chains the six coefficient grads back through the Taylor shift (the
// reference's _unshift_grad) and writes the group's 16-lane partial of the
// slot.
// combine_groups_kernel then adds the groups in order and writes each
// slot's 16 lanes (ids 0), zeros past the strip's count. No early stop,
// no atomics, so the output is the same on every run; gather_rows'
// backward adds the slots into the table.
constexpr int kOutCh = 7;
constexpr int kSums = 6 + kOutCh;   // eval-frame moments, colour sums
constexpr int kPartStride = 17;     // floats per (warp, entry): no bank clash
constexpr float kLn2 = 0.6931471805599453f;

__global__ void __launch_bounds__(kThreads)
composite_bwd_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ idx,
                     const int32_t* __restrict__ count,
                     const float* __restrict__ tfin,
                     const float* __restrict__ gout,
                     float* __restrict__ dpart, int table_rows, int cs,
                     int nrows, int ncols) {
  __shared__ float4 s_coef[2][kChunk];   // cA cB cC cD | cE cF u v
  __shared__ float4 s_col[2][kChunk];    // colours 0-3 | 4-6, 0
  __shared__ float s_part[kWarps][kChunk][kPartStride];

  const int strip = blockIdx.x / kGroups;
  const int group = blockIdx.x % kGroups;
  const int sr = strip / ncols;
  const int sc = strip % ncols;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  int tx, row0;
  thread_pixels(tid, group, &tx, &row0);
  const float fsc = (float)sc;
  const float fsr = (float)sr;
  const float x = (float)(tx - kStrip / 2);
  const float xx = x * x;

  int n = count[strip];
  n = n < 0 ? 0 : (n > cs ? cs : n);
  const int32_t* list = idx + (int64_t)strip * cs;
  float* part = dpart + (int64_t)blockIdx.x * cs * kCoefDim;

  const int64_t plane = (int64_t)nrows * kStrip * ncols * kStrip;
  const int64_t width = (int64_t)ncols * kStrip;
  float d[kRows], y[kRows], yy[kRows];
  float g[kOutCh][kRows], T[kRows], gs[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    d[r] = (float)(row0 + r);
    y[r] = (float)(row0 + r - kStrip / 2);
    yy[r] = y[r] * y[r];
    const int64_t pix = (int64_t)(sr * kStrip + row0 + r) * width
                        + sc * kStrip + tx;
#pragma unroll
    for (int c = 0; c < kOutCh; ++c) g[c][r] = gout[c * plane + pix];
    T[r] = tfin[pix];
    gs[r] = gout[kOutCh * plane + pix] * T[r];
  }

  for (int base = ((n - 1) / kChunk) * kChunk; n > 0 && base >= 0;
       base -= kChunk) {
    const int m = (n - base) < kChunk ? (n - base) : kChunk;
    __syncthreads();   // the previous chunk's readers are done
    if (tid < m) {
      float r[kCoefDim], c6[6], u, v;
      load_row(table, list[base + tid], table_rows, r);
      shift_row(r, fsc, fsr, c6, &u, &v);
      s_coef[0][tid] = make_float4(c6[0], c6[1], c6[2], c6[3]);
      s_coef[1][tid] = make_float4(c6[4], c6[5], u, v);
      s_col[0][tid] = make_float4(r[kR], r[kR + 1], r[kR + 2], r[kR + 3]);
      s_col[1][tid] = make_float4(r[kR + 4], r[kR + 5], r[kR + 6], 0.0f);
    }
    __syncthreads();
    for (int e = m - 1; e >= 0; --e) {
      const float4 q0 = s_coef[0][e];
      const float4 q1 = s_coef[1][e];
      const float c6[6] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y};
      const Columns k = entry_columns(c6, x, xx);
      float p[kRows];
      bool live = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        p[r] = entry_power(k, d[r]);
        live = live || (p[r] >= kPowerCut);
      }
      if (!__any_sync(kFull, live)) {
        if (lane < kSums) s_part[warp][e][lane] = 0.0f;
        continue;
      }
      const float4 k0 = s_col[0][e];
      const float4 k1 = s_col[1][e];
      const float col[kOutCh] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z};
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      float cw[kOutCh];
#pragma unroll
      for (int c = 0; c < kOutCh; ++c) cw[c] = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float ar;
        const float a = entry_alpha(p[r], &ar);
        const float inv = 1.0f / (1.0f - a);
        T[r] = T[r] * inv;
        const float w = a * T[r];
        float cg = g[0][r] * col[0];
#pragma unroll
        for (int c = 1; c < kOutCh; ++c) cg = cg + g[c][r] * col[c];
        const float dalpha = cg * T[r] - gs[r] * inv;
        gs[r] = gs[r] + cg * w;
        const bool gate = (ar >= kAlphaEps) && (ar < kAlphaMax);
        const float dpow = ((gate ? dalpha : 0.0f) * ar) * kLn2;
        s0 = s0 + dpow;
        s1 = s1 + dpow * y[r];
        s2 = s2 + dpow * yy[r];
#pragma unroll
        for (int c = 0; c < kOutCh; ++c) cw[c] = cw[c] + w * g[c][r];
      }
      float v[kSums] = {xx * s0, x * s1, s2, x * s0, s1, s0,
                        cw[0], cw[1], cw[2], cw[3], cw[4], cw[5], cw[6]};
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < kSums; ++q)
          v[q] += __shfl_xor_sync(kFull, v[q], off);
      }
#pragma unroll
      for (int q = 0; q < kSums; ++q)
        if (lane == q) s_part[warp][e][q] = v[q];
    }
    __syncthreads();
    // per entry: the warps' sums in warp order (dA..dF on the eval-frame
    // coefficients, then the colours), the six chained back through the
    // Taylor shift; the group's partial of the slot, 16 lanes
    for (int e = tid; e < m; e += kThreads) {
      float s[kSums];
#pragma unroll
      for (int j = 0; j < kSums; ++j) {
        s[j] = s_part[0][e][j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s[j] = s[j] + s_part[w][e][j];
      }
      const float u = s_coef[1][e].z, v = s_coef[1][e].w;
      const float dA = s[0], dB = s[1], dC = s[2];
      const float dD = s[3], dE = s[4], dF = s[5];
      float4* o = reinterpret_cast<float4*>(part + (int64_t)(base + e) * kCoefDim);
      o[0] = make_float4((dA + (2.0f * u) * dD) + (u * u) * dF,
                         ((dB + v * dD) + u * dE) + (u * v) * dF,
                         (dC + (2.0f * v) * dE) + (v * v) * dF, dD + u * dF);
      o[1] = make_float4(dE + v * dF, dF, s[6], s[7]);
      o[2] = make_float4(s[8], s[9], s[10], s[11]);
      o[3] = make_float4(s[12], 0.0f, 0.0f, 0.0f);
    }
  }
}

// dslot[strip, slot, :] = the sum of the slot's group partials, in group
// order, for slot < count[strip]; zeros past it. One thread per float4 of
// the output.
__global__ void combine_groups_kernel(const float4* __restrict__ dpart,
                                      const int32_t* __restrict__ count,
                                      float4* __restrict__ dslot, int cs,
                                      int strips) {
  const int64_t per_strip = (int64_t)cs * (kCoefDim / 4);
  const int64_t total = (int64_t)strips * per_strip;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int strip = (int)(i / per_strip);
  const int64_t within = i - (int64_t)strip * per_strip;
  const int slot = (int)(within / (kCoefDim / 4));
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (slot < count[strip]) {
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const float4 v =
          dpart[((int64_t)strip * kGroups + g) * per_strip + within];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  dslot[i] = acc;
}

}  // namespace

// out: (out_ch + 1, nrows*32, ncols*32) float32; entries: optional (Ns,)
// int32, zeroed by the caller, receives the most list entries any row
// group of each strip composited. out_ch 7 composites every entry; out_ch
// 3 or 4 exits early. Returns cudaError_t.
extern "C" int composite_strips_fwd(const float* table, const int32_t* idx,
                                    const int32_t* count, float* out,
                                    int32_t* entries, int table_rows, int cs,
                                    int nrows, int ncols, int out_ch,
                                    cudaStream_t stream) {
  if (nrows * ncols == 0) return 0;
  switch (out_ch) {
    case 7:
      return launch_fwd<7, false>(table, idx, count, out, entries, table_rows,
                                  cs, nrows, ncols, stream);
    case 4:
      return launch_fwd<4, true>(table, idx, count, out, entries, table_rows,
                                 cs, nrows, ncols, stream);
    case 3:
      return launch_fwd<3, true>(table, idx, count, out, entries, table_rows,
                                 cs, nrows, ncols, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dslot: (Ns, cs, 16) float32 per-slot home-frame row grads of the
// 7-channel composite, given the forward's T_final tfin (H, W) and the
// cotangent gout (8, H, W) of its 7 channels and T_final; dpart is scratch
// of (Ns, 4, cs, 16) float32, one partial per row group. Returns
// cudaError_t.
extern "C" int composite_strips_bwd(const float* table, const int32_t* idx,
                                    const int32_t* count, const float* tfin,
                                    const float* gout, float* dpart,
                                    float* dslot, int table_rows, int cs,
                                    int nrows, int ncols,
                                    cudaStream_t stream) {
  const int strips = nrows * ncols;
  if (strips == 0 || cs == 0) return 0;
  composite_bwd_kernel<<<strips * kGroups, kThreads, 0, stream>>>(
      table, idx, count, tfin, gout, dpart, table_rows, cs, nrows, ncols);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = (int64_t)strips * cs * (kCoefDim / 4);
  const int threads = 256;
  combine_groups_kernel<<<(unsigned)((total + threads - 1) / threads),
                          threads, 0, stream>>>(
      reinterpret_cast<const float4*>(dpart), count,
      reinterpret_cast<float4*>(dslot), cs, strips);
  return (int)cudaGetLastError();
}

// blocks: (4,) int32, receives the resident blocks per SM of K1 ch7, K1
// ch3, K3 and K3's group pass on the current device. Returns cudaError_t.
extern "C" int composite_strips_occupancy(int* blocks) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks[0], composite_fwd_kernel<7, false>, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[1], composite_fwd_kernel<3, true>, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[2], composite_bwd_kernel, kThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[3], combine_groups_kernel, 256, 0);
  return (int)e;
}
