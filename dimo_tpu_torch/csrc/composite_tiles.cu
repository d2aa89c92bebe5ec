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

// alpha of coefficients c6 at tile-local pixel (x, y), in
// composite_tiles_plain's op order; *araw receives exp(power) before the
// cut and the cap. K8 and K9 both call this, so K9 replays K8's alpha bit
// for bit.
__device__ __forceinline__ float tile_alpha(const float* c6, float x, float y,
                                            float* araw) {
  const float q1 = c6[1] * y + c6[3];
  const float q0 = (c6[2] * y + c6[4]) * y + c6[5];
  const float p = (c6[0] * x + q1) * x + q0;
  const float ar = expf(p);
  *araw = ar;
  return (ar >= kAlphaEps) ? fminf(ar, kAlphaMax) : 0.0f;
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
// replays alpha (13 ops with the exp), rebuilds T by one reciprocal and one
// product (3), forms w (1), the channel-weighted cotangent sum CG (13),
// dalpha (3), the running plane GS (2), the gate (2), dpower (2), dx and the
// ten per-pixel terms (10) and one add per term into the tile's sums (10):
// 59 float32 ops, against 4 MB of slabs, 9 MB of planes and 4 MB of output
// at 512^2 with capacity 1024, so the float32 rate sets the floor.
//
// Design: the same (tile, quarter) blocks as K8, one thread per pixel. The
// block walks the slab BACK TO FRONT in chunks of kBwdChunk entries; one
// thread per entry loads its row and parks the coefficients, the colours
// and (mx, my, ca, cb, cc, op) in shared memory. Each thread starts from
// the forward's T_final and GS = g_T * T_final, and per entry:
//   a = tile_alpha(...)              (K8's function: the same bits)
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
// A warp is one pixel row (fixed y), so the moments factor into three
// per-row sums (dpow, dpow*dx, dpow*dx^2); with the seven colour sums
// (w * gout_ch) that is ten values, reduced across the warp by xor shuffles
// and parked per (row, entry) in shared memory. After the chunk, threads
// sum the 32 rows with weights 1, dy, dy^2 into the thirteen per-entry sums
// (moments are additive, so a quarter's share stands on its own), form the
// six geometry grads and write the quarter's 16 lanes of the slot into a
// per-block partial (T, 4, cap, 16). A second small kernel adds each slot's
// four partials in a fixed order, and writes zeros past the tile's count:
// no atomics, so the result is deterministic and comparable slot by slot.
constexpr int kBwdChunk = 32;
constexpr int kRowSums = 10;   // dpow, dpow*x, dpow*x^2, w*g_0..w*g_6
constexpr int kOutCh = 7;
constexpr int kGeo = 6;        // mx, my, ca, cb, cc, op

__global__ void __launch_bounds__(kThreads)
composite_tiles_bwd_kernel(const float* __restrict__ packed,
                           const int32_t* __restrict__ counts,
                           const float* __restrict__ tfin,
                           const float* __restrict__ gout,
                           float* __restrict__ dpart, int cap, int nrows,
                           int ncols) {
  __shared__ float s_coef[6][kBwdChunk];
  __shared__ float s_col[kOutCh][kBwdChunk];
  __shared__ float s_geo[kGeo][kBwdChunk];
  __shared__ float s_part[kTileH][kBwdChunk][kRowSums];
  __shared__ float s_red[kBwdChunk][6 + kOutCh];

  const int tile = blockIdx.x / kQuarters;
  const int quarter = blockIdx.x % kQuarters;
  const int tr = tile / ncols;
  const int tc = tile % ncols;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kQuarter + tx;
  const float x_off = (float)(tc * kTileW);
  const float y_off = (float)(tr * kTileH);
  const float x = (float)(quarter * kQuarter + tx);
  const float y = (float)ty;

  int n = counts[tile];
  n = n < 0 ? 0 : (n > cap ? cap : n);
  const float* slab = packed + (int64_t)tile * cap * kAttrDim;
  float* part = dpart + (int64_t)blockIdx.x * cap * kAttrDim;

  const int64_t width = (int64_t)ncols * kTileW;
  const int64_t plane = (int64_t)nrows * kTileH * width;
  const int64_t pix = (int64_t)(tr * kTileH + ty) * width + tc * kTileW
                      + quarter * kQuarter + tx;
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
      float r[kAttrDim], c6[6], mx, my;
      load_row(slab + (int64_t)(base + tid) * kAttrDim, r);
      tile_coeffs(r, x_off, y_off, c6, &mx, &my);
#pragma unroll
      for (int k = 0; k < 6; ++k) s_coef[k][tid] = c6[k];
#pragma unroll
      for (int c = 0; c < kOutCh; ++c) s_col[c][tid] = r[kR + c];
      s_geo[0][tid] = mx;
      s_geo[1][tid] = my;
      s_geo[2][tid] = r[kCa];
      s_geo[3][tid] = r[kCb];
      s_geo[4][tid] = r[kCc];
      s_geo[5][tid] = r[kOp];
    }
    __syncthreads();
    for (int e = m - 1; e >= 0; --e) {
      const float c6[6] = {s_coef[0][e], s_coef[1][e], s_coef[2][e],
                           s_coef[3][e], s_coef[4][e], s_coef[5][e]};
      float ar;
      const float a = tile_alpha(c6, x, y, &ar);
      const float inv = 1.0f / (1.0f - a);
      T = T * inv;
      const float w = a * T;
      float cg = g[0] * s_col[0][e];
#pragma unroll
      for (int c = 1; c < kOutCh; ++c) cg = cg + g[c] * s_col[c][e];
      const float dalpha = cg * T - gs * inv;
      gs = gs + cg * w;
      const bool gate = (ar >= kAlphaEps) && (ar < kAlphaMax);
      const float dpow = (gate ? dalpha : 0.0f) * ar;
      const float dx = x - s_geo[0][e];
      float v[kRowSums];
      v[0] = dpow;
      v[1] = dpow * dx;
      v[2] = v[1] * dx;
#pragma unroll
      for (int c = 0; c < kOutCh; ++c) v[3 + c] = w * g[c];
#pragma unroll
      for (int off = kQuarter / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < kRowSums; ++q)
          v[q] += __shfl_xor_sync(0xffffffffu, v[q], off);
      }
#pragma unroll
      for (int q = 0; q < kRowSums; ++q)
        if (tx == q) s_part[ty][e][q] = v[q];
    }
    __syncthreads();
    // per entry, over the rows (dy = row - my): Mxx = sum S2, Mxy = sum
    // dy*S1, Myy = sum dy^2*S0, Mx = sum S1, My = sum dy*S0, M0 = sum S0;
    // colours sum C_c
    for (int t = tid; t < m * (6 + kOutCh); t += kThreads) {
      const int e = t / (6 + kOutCh);
      const int k = t % (6 + kOutCh);
      const int src = k < 6 ? (k == 0 ? 2 : (k == 1 || k == 3) ? 1 : 0)
                            : 3 + (k - 6);
      const int pw = (k == 2) ? 2 : (k == 1 || k == 4) ? 1 : 0;
      const float my = s_geo[1][e];
      float acc = 0.0f;
      for (int rr = 0; rr < kTileH; ++rr) {
        const float dy = (float)rr - my;
        const float wt = pw == 0 ? 1.0f : (pw == 1 ? dy : dy * dy);
        acc = acc + wt * s_part[rr][e][src];
      }
      s_red[e][k] = acc;
    }
    __syncthreads();
    for (int t = tid; t < m * kAttrDim; t += kThreads) {
      const int e = t / kAttrDim;
      const int lane = t % kAttrDim;
      const float ca = s_geo[2][e], cb = s_geo[3][e], cc = s_geo[4][e];
      const float op = s_geo[5][e];
      const float Mxx = s_red[e][0], Mxy = s_red[e][1], Myy = s_red[e][2];
      const float Mx = s_red[e][3], My = s_red[e][4], M0 = s_red[e][5];
      float val = 0.0f;
      switch (lane) {
        case kMx: val = ca * Mx + cb * My; break;
        case kMy: val = cb * Mx + cc * My; break;
        case kCa: val = -0.5f * Mxx; break;
        case kCb: val = -Mxy; break;
        case kCc: val = -0.5f * Myy; break;
        case kOp: val = op > kOpFloor ? M0 / fmaxf(op, kOpFloor) : 0.0f; break;
        default: val = lane < kR + kOutCh ? s_red[e][lane] : 0.0f;
      }
      part[(int64_t)(base + e) * kAttrDim + lane] = val;
    }
  }
}

// dpacked[tile, slot, :] = the sum of the slot's four quarter partials, in
// quarter order, for slot < count[tile]; zeros past it. One thread per
// float4 of the output.
__global__ void combine_quarters_kernel(const float4* __restrict__ dpart,
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
    for (int q = 0; q < kQuarters; ++q) {
      const float4 v = dpart[((int64_t)tile * kQuarters + q) * per_tile + within];
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
// of (nrows*ncols, 4, cap, 16) float32. Returns cudaError_t.
extern "C" int composite_tiles_bwd(const float* packed, const int32_t* counts,
                                   const float* tfin, const float* gout,
                                   float* dpart, float* dpacked, int cap,
                                   int nrows, int ncols, cudaStream_t stream) {
  const int tiles = nrows * ncols;
  if (tiles == 0 || cap == 0) return 0;
  const dim3 block(kQuarter, kTileH);
  composite_tiles_bwd_kernel<<<tiles * kQuarters, block, 0, stream>>>(
      packed, counts, tfin, gout, dpart, cap, nrows, ncols);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t total = (int64_t)tiles * cap * (kAttrDim / 4);
  const int threads = 256;
  combine_quarters_kernel<<<(unsigned)((total + threads - 1) / threads),
                            threads, 0, stream>>>(
      reinterpret_cast<const float4*>(dpart), counts,
      reinterpret_cast<float4*>(dpacked), cap, tiles);
  return (int)cudaGetLastError();
}
