// Tile compositor: kernel K8, the forward (front-to-back alpha blending of
// depth-ordered per-tile attribute slabs over 32x128-pixel tiles, 7, 4 or 3
// channels, no early exit), and kernel K9, the 7-channel composite's VJP.
//
// K8 replaces dimo_tpu/ops/rasterizer/composite_pallas.py:_fwd_kernel
// (called through _fwd_call by composite and composite_infer); K9 replaces
// its _bwd_kernel (called through _bwd_call by the custom VJP
// _composite_bwd). K9 is described above its kernel. This compositor shares
// no code with the strip compositor (composite_strips.cu): tile-local
// coordinates, the log-opacity folded into the exponent, exp instead of
// exp2, and slabs of packed attributes instead of a coefficient table read
// by list index. An image and a gradient that agree between the two check
// both.
//
// K8:
//
// What bounds it on the H100: operations. Each (pixel, slab entry) pair
// costs 10 float32 ops for the quadratic (q1, q0 in y, Horner in x), one
// exp, the cut and the cap (2), w and T (2) and 2 per composited channel:
// 15 + 2*C, 29 at 7 channels. At 512^2 with capacity 1024 that is up to
// 65,536 entries x 4,096 pixels x 29 = 7.8 GFLOP against 4 MB of slabs and
// 8 MB of planes, so the float32 rate sets the floor, not the memory.
//
// Design: a tile is 32 rows x 128 columns, and 512^2 has only 64 of them
// for 132 SMs. So a tile is split into four 32x32 quarters along x, one
// 32x32-thread block per (tile, quarter), one thread per pixel: 256 blocks,
// two resident per SM, all reading the same slab (the second to fourth read
// hit L2). The contract stays per tile: one slab, one count. The block walks
// the slab in chunks of kChunk entries; the first kChunk threads each load
// one 64-byte row and compute its six tile-local coefficients once for the
// block (the reference's _chunk_coeffs), parked with the colours in shared
// memory; then every thread blends the chunk with T and the channel sums in
// registers. The loop runs to the tile's count exactly (the reference
// rounds up to its chunk and relies on the rows past the count being the
// zero dummy). The TPU's one-hot repeat matmuls, bf16 three-term splits and
// the capacity axis as a grid dimension do not carry over: a GPU broadcasts
// from shared memory and loops.
//
// Numerics: built with --fmad=false and written in the plain version's op
// order (composite_tiles_plain), so both round every product and sum alike;
// expf and logf are the full-precision routines (no fast math, denormals
// kept: the dummy row's op = 0 becomes log(1e-30), a normal float).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 128;
constexpr int kQuarter = 32;               // columns of a tile one block owns
constexpr int kQuarters = kTileW / kQuarter;
constexpr int kThreads = kTileH * kQuarter;
constexpr int kChunk = 256;                // slab entries staged per pass
constexpr int kAttrDim = 16;
// packed attribute lanes (tiles.py)
constexpr int kMx = 0, kMy = 1, kCa = 2, kCb = 3, kCc = 4, kOp = 5, kR = 6;
constexpr float kAlphaEps = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kOpFloor = 1e-30f;

// One slab row (16 floats) into registers.
__device__ __forceinline__ void load_row(const float* row, float* r) {
  const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v4 = row4[q];
    r[4 * q + 0] = v4.x;
    r[4 * q + 1] = v4.y;
    r[4 * q + 2] = v4.z;
    r[4 * q + 3] = v4.w;
  }
}

// Tile-local quadratic coefficients (cA, cB, cC, cD, cE, cF) of a slab row
// for the tile whose top-left pixel is (x_off, y_off), the log-opacity
// folded into cF; also the tile-local centre (mx, my). Shared by K8 and K9.
__device__ __forceinline__ void tile_coeffs(const float* r, float x_off,
                                            float y_off, float* c6,
                                            float* mx_out, float* my_out) {
  const float mx = r[kMx] - x_off;
  const float my = r[kMy] - y_off;
  const float ca = r[kCa], cb = r[kCb], cc = r[kCc];
  const float cA = -0.5f * ca;
  const float cC = -0.5f * cc;
  c6[0] = cA;
  c6[1] = -cb;
  c6[2] = cC;
  c6[3] = ca * mx + cb * my;
  c6[4] = cc * my + cb * mx;
  c6[5] = (((cA * mx) * mx + (cC * my) * my) - (cb * mx) * my)
          + logf(fmaxf(r[kOp], kOpFloor));
  *mx_out = mx;
  *my_out = my;
}

// The power of coefficients c6 at tile-local pixel (x, y), in
// composite_tiles_plain's op order.
__device__ __forceinline__ float tile_power(const float* c6, float x,
                                            float y) {
  const float q1 = c6[1] * y + c6[3];
  const float q0 = (c6[2] * y + c6[4]) * y + c6[5];
  return (c6[0] * x + q1) * x + q0;
}

// alpha of power p; *araw receives exp(p) before the cut and the cap.
__device__ __forceinline__ float power_alpha(float p, float* araw) {
  const float ar = expf(p);
  *araw = ar;
  return (ar >= kAlphaEps) ? fminf(ar, kAlphaMax) : 0.0f;
}

// alpha of coefficients c6 at tile-local pixel (x, y). K8 calls this and
// K9 the two functions it is made of, so K9 replays K8's alpha bit for
// bit.
__device__ __forceinline__ float tile_alpha(const float* c6, float x, float y,
                                            float* araw) {
  return power_alpha(tile_power(c6, x, y), araw);
}

template <int CH>
__global__ void __launch_bounds__(kThreads)
composite_tiles_fwd_kernel(const float* __restrict__ packed,
                           const int32_t* __restrict__ counts,
                           float* __restrict__ out, float* __restrict__ tfin,
                           int cap, int nrows, int ncols) {
  __shared__ float s_coef[6][kChunk];
  __shared__ float s_col[CH][kChunk];

  const int tile = blockIdx.x / kQuarters;
  const int quarter = blockIdx.x % kQuarters;
  const int tr = tile / ncols;
  const int tc = tile % ncols;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kQuarter + tx;
  const float x_off = (float)(tc * kTileW);
  const float y_off = (float)(tr * kTileH);
  const float x = (float)(quarter * kQuarter + tx);   // tile-local column
  const float y = (float)ty;                           // tile-local row

  int n = counts[tile];
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const float* slab = packed + (int64_t)tile * cap * kAttrDim;

  float T = 1.0f;
  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0.0f;

  for (int base = 0; base < n; base += kChunk) {
    if (base > 0) __syncthreads();   // the previous chunk's readers are done
    const int m = (n - base) < kChunk ? (n - base) : kChunk;
    if (tid < m) {
      float r[kAttrDim], c6[6], mx, my;
      load_row(slab + (int64_t)(base + tid) * kAttrDim, r);
      tile_coeffs(r, x_off, y_off, c6, &mx, &my);
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
      const float a = tile_alpha(c6, x, y, &ar);
      const float w = a * T;
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[c] = acc[c] + s_col[c][e] * w;
      T = T - w;
    }
  }

  const int64_t width = (int64_t)ncols * kTileW;
  const int64_t plane = (int64_t)nrows * kTileH * width;
  const int64_t pix = (int64_t)(tr * kTileH + ty) * width + tc * kTileW
                      + quarter * kQuarter + tx;
#pragma unroll
  for (int c = 0; c < CH; ++c) out[c * plane + pix] = acc[c];
  tfin[pix] = T;
}

template <int CH>
int launch_fwd(const float* packed, const int32_t* counts, float* out,
               float* tfin, int cap, int nrows, int ncols,
               cudaStream_t stream) {
  const dim3 block(kQuarter, kTileH);
  composite_tiles_fwd_kernel<CH>
      <<<nrows * ncols * kQuarters, block, 0, stream>>>(
          packed, counts, out, tfin, cap, nrows, ncols);
  return (int)cudaGetLastError();
}


// K9: the 7-channel tile composite's VJP, per slab slot.
//
// What bounds it on the H100: operations. Per (pixel, slab entry) pair it
// forms the power (10 float32 ops), replays alpha (3 with the exp), rebuilds
// T by one reciprocal and one product (3), forms w (1), the channel-weighted
// cotangent sum CG (13), dalpha (3), the running plane GS (2), the gate (2),
// dpower (2), dy and the per-pixel terms (10) and one add per term into the
// tile's sums (10): 59 float32 ops, against 4 MB of slabs, 9 MB of planes
// and 4 MB of output at 512^2 with capacity 1024, so the float32 rate sets
// the floor. A pair whose alpha is 0 needs only its power.
//
// Design, K3's (composite_strips.cu) on the tile: a tile's 32 rows are cut
// into kGroups row groups of 8 rows x 128 columns, one 256-thread block per
// (tile, group): 256 blocks at 512^2, one wave. A thread owns kRows
// consecutive rows of one column; a warp covers 16 columns x 8 rows, the
// squarest band of a group. The block walks the slab BACK TO FRONT in
// chunks of kBwdChunk entries; one thread per entry loads its row and parks
// the coefficients (tile_coeffs, K8's), its centre, the colours and (ca, cb,
// cc, op) in shared memory. Each thread starts from the forward's T_final
// and GS = g_T * T_final of its rows, and per entry forms the power of its
// rows (tile_power, K8's). A warp whose pixels all lie below kPowerCut skips
// the entry: there expf gives < 1/255, alpha is exactly 0, so inv = 1 and
// w = 0 and the pair changes neither T nor GS nor any sum. Otherwise, per
// row:
//   a = power_alpha(p)               (K8's function: the same bits)
//   inv = 1 / (1 - a);  T = T * inv  (T in front of the entry)
//   CG = sum_ch gout_ch * c_ch;  dalpha = CG*T - GS*inv;  GS += CG*a*T
//   dpow = [1/255 <= araw < 0.99] * dalpha * araw   (d loss / d power)
// The six geometry grads are moments of dpow about the entry's OWN centre,
// dx = x - mx, dy = y - my (d power / d ca = -dx^2 / 2, / d cb = -dx dy,
// / d cc = -dy^2 / 2, / d mx = ca dx + cb dy, / d my = cb dx + cc dy,
// / d op = 1 / op). The reference sums moments of the tile-local x and y and
// chains them through the expanded coefficients, where three terms of the
// order of mx^2 * sum(dpow) cancel down to sigma^2 * sum(dpow): in float32
// that made the result depend on the order of the sums at the 1e-4 level.
// The centred moments are the same derivative without the cancellation.
// A thread sums its rows (fixed x) into S0 = sum dpow, S1 = sum dpow*dy,
// S2 = sum dpow*dy^2 and the colour sums sum w*gout_ch, so its share of the
// moments is (dx S0, S1, dx^2 S0, dx S1, S2, S0): thirteen values, summed
// over the warp by five xor-shuffle levels each (13 independent chains)
// and parked per (warp, entry) in shared memory (stride 17 words: no bank
// conflict). After the chunk, one thread per (entry, float4 of the slot)
// adds the warps' sums of its four lanes in warp order and writes the
// group's partial of the slot: (T, kGroups, cap, 16), 16.8 MB at 512^2
// with capacity 1024. combine_groups_kernel then adds each slot's partials
// in group order and writes zeros past the tile's count. No early stop, no
// atomics: the result is the same on every run.
//
// Measured in a CUDA graph on NVIDIA H100 80GB HBM3, 700.00 W
// (chip_smoke.py, PERF.md, Findings), in turns at 512^2 with capacity 1024
// (51,807 entries, 3.08% of the 212 M pixel-entry pairs with alpha > 0):
// 0.439-0.440 ms (80 registers, 3 blocks an SM) against 2.702-2.703 for
// the design it replaced (one 1,024-thread block per 32x32 quarter of a
// tile, a warp per pixel row reducing ten terms for every pair, then 32
// rows summed serially per entry); without the power cut 1.282-1.284.
constexpr int kRows = 4;                   // pixel rows a thread owns
constexpr int kGroupRows = 8;              // rows of a row group: one block
constexpr int kGroups = kTileH / kGroupRows;   // blocks (partials) a tile
constexpr int kBwdThreads = kTileW * kGroupRows / kRows;   // 256
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kWarpCols = 16;              // a warp: 16 columns x 8 rows
constexpr int kBwdChunk = 64;              // slab entries staged per pass
constexpr int kOutCh = 7;
constexpr int kSums = 6 + kOutCh;          // moments, colour sums
constexpr int kPartStride = 17;            // floats per (warp, entry)
constexpr unsigned kFull = 0xffffffffu;
// below this power expf gives < 1/255: alpha is exactly 0
// (composite_tiles.py: POWER_CUT, pinned by a test)
constexpr float kPowerCut = -5.6f;
static_assert(kBwdThreads == 4 * kBwdChunk,
              "one thread per float4 of a chunk's slots");
static_assert(kBwdWarps * kWarpCols == kTileW &&
                  kRows * (32 / kWarpCols) == kGroupRows,
              "the warps of a block lie side by side across the tile");

__global__ void __launch_bounds__(kBwdThreads)
composite_tiles_bwd_kernel(const float* __restrict__ packed,
                           const int32_t* __restrict__ counts,
                           const float* __restrict__ tfin,
                           const float* __restrict__ gout,
                           float* __restrict__ dpart, int cap, int nrows,
                           int ncols) {
  __shared__ float4 s_coef[2][kBwdChunk];   // cA cB cC cD | cE cF mx my
  __shared__ float4 s_col[2][kBwdChunk];    // colours 0-3 | 4-6, 0
  __shared__ float4 s_geo[kBwdChunk];       // ca cb cc op
  __shared__ float s_part[kBwdWarps][kBwdChunk][kPartStride];

  const int tile = blockIdx.x / kGroups;
  const int group = blockIdx.x % kGroups;
  const int tr = tile / ncols;
  const int tc = tile % ncols;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int col = warp * kWarpCols + lane % kWarpCols;    // tile-local
  const int row0 = group * kGroupRows + (lane / kWarpCols) * kRows;
  const float x_off = (float)(tc * kTileW);
  const float y_off = (float)(tr * kTileH);
  const float x = (float)col;

  int n = counts[tile];
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const float* slab = packed + (int64_t)tile * cap * kAttrDim;
  float* part = dpart + (int64_t)blockIdx.x * cap * kAttrDim;

  const int64_t width = (int64_t)ncols * kTileW;
  const int64_t plane = (int64_t)nrows * kTileH * width;
  float y[kRows], g[kOutCh][kRows], T[kRows], gs[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    y[r] = (float)(row0 + r);
    const int64_t pix = (int64_t)(tr * kTileH + row0 + r) * width
                        + tc * kTileW + col;
#pragma unroll
    for (int c = 0; c < kOutCh; ++c) g[c][r] = gout[c * plane + pix];
    T[r] = tfin[pix];
    gs[r] = gout[kOutCh * plane + pix] * T[r];
  }

  for (int base = ((n - 1) / kBwdChunk) * kBwdChunk; n > 0 && base >= 0;
       base -= kBwdChunk) {
    const int m = (n - base) < kBwdChunk ? (n - base) : kBwdChunk;
    __syncthreads();   // the previous chunk's readers are done
    if (tid < m) {
      float r[kAttrDim], c6[6], mx, my;
      load_row(slab + (int64_t)(base + tid) * kAttrDim, r);
      tile_coeffs(r, x_off, y_off, c6, &mx, &my);
      s_coef[0][tid] = make_float4(c6[0], c6[1], c6[2], c6[3]);
      s_coef[1][tid] = make_float4(c6[4], c6[5], mx, my);
      s_col[0][tid] = make_float4(r[kR], r[kR + 1], r[kR + 2], r[kR + 3]);
      s_col[1][tid] = make_float4(r[kR + 4], r[kR + 5], r[kR + 6], 0.0f);
      s_geo[tid] = make_float4(r[kCa], r[kCb], r[kCc], r[kOp]);
    }
    __syncthreads();
    for (int e = m - 1; e >= 0; --e) {
      const float4 q0 = s_coef[0][e];
      const float4 q1 = s_coef[1][e];
      const float c6[6] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y};
      float p[kRows];
      bool live = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        p[r] = tile_power(c6, x, y[r]);
        live = live || (p[r] >= kPowerCut);
      }
      if (!__any_sync(kFull, live)) {
        if (lane < kSums) s_part[warp][e][lane] = 0.0f;
        continue;
      }
      const float4 k0 = s_col[0][e];
      const float4 k1 = s_col[1][e];
      const float cl[kOutCh] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z};
      const float mx = q1.z, my = q1.w;
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
      float cw[kOutCh];
#pragma unroll
      for (int c = 0; c < kOutCh; ++c) cw[c] = 0.0f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float ar;
        const float a = power_alpha(p[r], &ar);
        const float inv = 1.0f / (1.0f - a);
        T[r] = T[r] * inv;
        const float w = a * T[r];
        float cg = g[0][r] * cl[0];
#pragma unroll
        for (int c = 1; c < kOutCh; ++c) cg = cg + g[c][r] * cl[c];
        const float dalpha = cg * T[r] - gs[r] * inv;
        gs[r] = gs[r] + cg * w;
        const bool gate = (ar >= kAlphaEps) && (ar < kAlphaMax);
        const float dpow = (gate ? dalpha : 0.0f) * ar;
        const float dy = y[r] - my;
        const float t = dpow * dy;
        s0 = s0 + dpow;
        s1 = s1 + t;
        s2 = s2 + t * dy;
#pragma unroll
        for (int c = 0; c < kOutCh; ++c) cw[c] = cw[c] + w * g[c][r];
      }
      const float dx = x - mx;
      const float t0 = s0 * dx;
      // Mx, My, Mxx, Mxy, Myy, M0, then the colours: the slot's lanes
      // 0-3 need sums 0-3, lanes 4-7 sums 4-7, and so on
      float v[kSums] = {t0, s1, t0 * dx, s1 * dx, s2, s0, cw[0], cw[1],
                        cw[2], cw[3], cw[4], cw[5], cw[6]};
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
    // one thread per (entry, float4 of its slot): the warps' sums in warp
    // order, then the group's partial of the four lanes
    if (tid < 4 * m) {
      const int e = tid / 4;
      const int quad = tid % 4;
      const int nq = quad < 3 ? 4 : kSums - 12;
      float sm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < nq) {
          float acc = s_part[0][e][4 * quad + i];
#pragma unroll
          for (int w = 1; w < kBwdWarps; ++w)
            acc = acc + s_part[w][e][4 * quad + i];
          sm[i] = acc;
        }
      }
      float4 o;
      if (quad == 0) {
        const float4 geo = s_geo[e];             // ca cb cc op
        o = make_float4(geo.x * sm[0] + geo.y * sm[1],      // mx
                        geo.y * sm[0] + geo.z * sm[1],      // my
                        -0.5f * sm[2], -sm[3]);             // ca, cb
      } else if (quad == 1) {
        const float op = s_geo[e].w;
        o = make_float4(-0.5f * sm[0],                      // cc
                        op > kOpFloor ? sm[1] / fmaxf(op, kOpFloor) : 0.0f,
                        sm[2], sm[3]);                      // op, c0, c1
      } else {
        o = make_float4(sm[0], sm[1], sm[2], sm[3]);        // c2-c5, c6 0 0 0
      }
      float4* slot = reinterpret_cast<float4*>(part + (int64_t)(base + e)
                                               * kAttrDim);
      slot[quad] = o;
    }
  }
}

// dpacked[tile, slot, :] = the sum of the slot's group partials, in group
// order, for slot < count[tile]; zeros past it. One thread per float4 of
// the output.
__global__ void combine_groups_kernel(const float4* __restrict__ dpart,
                                      const int32_t* __restrict__ counts,
                                      float4* __restrict__ dpacked, int cap,
                                      int tiles) {
  const int64_t per_tile = (int64_t)cap * (kAttrDim / 4);
  const int64_t total = (int64_t)tiles * per_tile;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int tile = (int)(i / per_tile);
  const int64_t within = i - (int64_t)tile * per_tile;
  const int slot = (int)(within / (kAttrDim / 4));
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (slot < counts[tile]) {
#pragma unroll
    for (int q = 0; q < kGroups; ++q) {
      const float4 v = dpart[((int64_t)tile * kGroups + q) * per_tile + within];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
  }
  dpacked[i] = acc;
}

}  // namespace

// packed: (nrows*ncols, cap, 16) float32 slabs; counts: (nrows, ncols) int32
// live entries per tile; out: (out_ch, nrows*32, ncols*128) float32; tfin:
// (nrows*32, ncols*128) float32. out_ch 7, 4 or 3; every variant composites
// every live entry. Returns cudaError_t.
extern "C" int composite_tiles_fwd(const float* packed, const int32_t* counts,
                                   float* out, float* tfin, int cap, int nrows,
                                   int ncols, int out_ch,
                                   cudaStream_t stream) {
  if (nrows * ncols == 0) return 0;
  switch (out_ch) {
    case 7:
      return launch_fwd<7>(packed, counts, out, tfin, cap, nrows, ncols,
                           stream);
    case 4:
      return launch_fwd<4>(packed, counts, out, tfin, cap, nrows, ncols,
                           stream);
    case 3:
      return launch_fwd<3>(packed, counts, out, tfin, cap, nrows, ncols,
                           stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dpacked: (nrows*ncols, cap, 16) float32 grads of the 7-channel composite
// on the slab rows, given the forward's T_final tfin (H, W) and the
// cotangent gout (8, H, W) of its 7 channels and T_final; dpart is scratch
// of (nrows*ncols, 4, cap, 16) float32, one partial per row group.
// Returns cudaError_t.
extern "C" int composite_tiles_bwd(const float* packed, const int32_t* counts,
                                   const float* tfin, const float* gout,
                                   float* dpart, float* dpacked, int cap,
                                   int nrows, int ncols, cudaStream_t stream) {
  const int tiles = nrows * ncols;
  if (tiles == 0 || cap == 0) return 0;
  composite_tiles_bwd_kernel<<<tiles * kGroups, kBwdThreads, 0, stream>>>(
      packed, counts, tfin, gout, dpart, cap, nrows, ncols);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = (int64_t)tiles * cap * (kAttrDim / 4);
  const int threads = 256;
  combine_groups_kernel<<<(unsigned)((total + threads - 1) / threads),
                          threads, 0, stream>>>(
      reinterpret_cast<const float4*>(dpart), counts,
      reinterpret_cast<float4*>(dpacked), cap, tiles);
  return (int)cudaGetLastError();
}

// blocks: (2,) int32, receives the resident blocks per SM of K9 and of its
// group pass on the current device. Returns cudaError_t.
extern "C" int composite_tiles_occupancy(int* blocks) {
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks[0], composite_tiles_bwd_kernel, kBwdThreads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks[1], combine_groups_kernel, 256, 0);
  return (int)e;
}
