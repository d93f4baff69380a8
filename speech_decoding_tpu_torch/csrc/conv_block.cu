// One whole eval-mode ConvBlock in one launch:
//   y0 = GELU(BN0(conv3(x, W0, d0) + b0 [+ x if k > 0]))      -> x's dtype
//   y1 = GELU(BN1(conv3(y0, W1, d1) + b1 + y0))               -> x's dtype
//   out = GLU(conv3(y1, W2, 2) + b2)                          -> x's dtype
// with BN folded to a per-channel affine (a[0] = scale, a[1] = offset), exact
// (erf) GELU, dilations d0 = 2^((2k)%5), d1 = 2^((2k+1)%5), 'SAME' zero
// padding of EACH conv's own input, f32 accumulation and f32 bias/skip/affine.
//
// Replaces the Pallas TPU kernel speech_decoding_tpu/ops/pallas/conv_block.py
// (conv_block_fused / _block_kernel). The Pallas kernel keeps a whole batch
// row, (360, 320) plus the (360, 640) conv2 result, and all weights in VMEM.
// Neither fits the 227 KB of shared memory an H100 block can have, so here
// each thread block takes one (batch row, tile of TT output times) and
// recomputes a halo: y0 over the tile widened by d1 + 2 on each side, y1 over
// the tile widened by 2, then the GLU output on the tile. The x window
// (widened by d0 + d1 + 2) and y0 live in shared memory, y1 overwrites the x
// window once conv0 is done. Rows whose time falls outside [0, T) are set to
// zero before the next conv reads them, exactly like the per-conv padding of
// the reference. Weights are read from device memory (the whole block's
// weights, 2.4 MB in bf16, stay in the 50 MB L2).
//
// What bounds it on an H100: operations. For k >= 1 at B=64, T=360, D2=320 a
// block is 56.6 GFLOP against ~30 MB of input and output, i.e. ~57 us of bf16
// tensor-core time against ~10 us of memory time. Two paths:
//   * bf16 (the serving dtype): the three convs run on the tensor cores with
//     warp-level mma (nvcuda::wmma, 16x16x16 bf16 -> f32). The block computes
//     (64-row x 320-channel) output tiles, each warp 2 x 5 fragments (x2 for
//     the GLU gate); weights stream through shared memory in 16-deep chunks
//     on a 3-deep cp.async ring, so each staged chunk feeds 64 rows; A
//     fragments are read in place from the activation buffers; each
//     accumulator goes through a small per-warp f32 scratch for the epilogue.
//     Needs D2 % 16 == 0 and conv0's weights zero-padded to a multiple of 16
//     input channels (prepare_fused_stack pads them once). Measured at
//     ~0.9 ms per block at B=64, ~16x its bound: neither a deeper ring nor
//     16 warps per block helped, so the next step is wgmma with TMA, not
//     more of this tiling.
//   * f32: a CUDA-core version (f32 FMA, 4x4 register tile per thread,
//     weights staged through shared memory in 32 x 128 chunks).
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaGetLastError() of the launch (or of the shared-memory attribute call).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cuda_pipeline.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RT = 32;   // f32 path: output rows per register tile (8 warps x 4 rows)
constexpr int CT = 128;  // f32 path: output channels per register tile (32 lanes x 4)
constexpr int KC = 32;   // f32 path: contraction chunk staged in shared memory
constexpr int TR = 64;    // bf16 path: output rows per block tile (4 row fragments)
constexpr int WRF = 2;    // bf16 path: row fragments per warp (2 warps down)
constexpr int MAXF = 5;   // bf16 path: channel fragments per warp (4 warps across)
constexpr int TN = 16 * 4 * MAXF;  // bf16 path: output channels per block tile (320)
constexpr int KB = 16;    // bf16 path: depth of a weight chunk staged in shared memory
constexpr int LDB = TN + 8;        // its row stride: 656 bytes, 8 rows hit 8 distinct bank groups
constexpr int NSTAGE = 3;          // weight chunks in flight (cp.async ring)
constexpr size_t kBChunks = (size_t)NSTAGE * 2 * KB * LDB * sizeof(bf16);  // x (value, gate)
constexpr size_t kScratch = (size_t)WARPS * 2 * 256 * sizeof(float);  // bf16 path epilogue
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most one H100 block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// ---- epilogues (shared by both paths) -------------------------------------

// conv0: bias, skip (k > 0), folded BN0, GELU, cast; zero outside [0, T)
template <typename T>
struct Epi0 {
  const T* x_s; int ldx; int d0; int skip;
  const float* b0; const float* a0; int D2;
  T* y0_s; int ldy; int tau0; int Tlen;
  __device__ void operator()(int r, int c, float v, float) const {
    const int tau = tau0 + r;
    float o = 0.f;
    if (tau >= 0 && tau < Tlen) {
      v += b0[c];
      if (skip) v += to_f(x_s[(size_t)(r + d0) * ldx + c]);
      o = gelu(v * a0[c] + a0[D2 + c]);
    }
    y0_s[(size_t)r * ldy + c] = from_f<T>(o);
  }
};

// conv1: bias, skip from y0, folded BN1, GELU, cast; zero outside [0, T)
template <typename T>
struct Epi1 {
  const T* y0_s; int ldy; int d1;
  const float* b1; const float* a1; int D2;
  T* y1_s; int tau0; int Tlen;
  __device__ void operator()(int r, int c, float v, float) const {
    const int tau = tau0 + r;
    float o = 0.f;
    if (tau >= 0 && tau < Tlen) {
      v += b1[c] + to_f(y0_s[(size_t)(r + d1) * ldy + c]);
      o = gelu(v * a1[c] + a1[D2 + c]);
    }
    y1_s[(size_t)r * ldy + c] = from_f<T>(o);
  }
};

// conv2: bias, GLU over the two channel halves, cast, store to device memory
template <typename T>
struct Epi2 {
  const float* b2; int D2;
  T* out; int t0;
  __device__ void operator()(int r, int c, float v, float g) const {
    v += b2[c];
    g += b2[D2 + c];
    out[(size_t)(t0 + r) * D2 + c] = from_f<T>(v * (1.f / (1.f + expf(-g))));
  }
};

// ---- block geometry ---------------------------------------------------------

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

struct Geometry {
  int TT, d0, d1, RX, R1, R2;  // time tile; dilations; x-window, y0 and y1 rows
  int ldx, ldy, kx;            // row strides of the x window and of y0/y1; conv0 depth
  size_t bufA, y0, smem;       // element counts of the two activation buffers, bytes in all
};

// f32 path: rows exactly as needed, unpadded strides, weight chunk of 32 x 128.
// bf16 path: strides padded to 16 elements (+16 against bank conflicts);
// each A operand gets the spare rows that the last 16-row fragment of the
// stage reading it overhangs (those rows are computed and dropped); the
// weight-chunk ring and the per-warp epilogue scratch.
template <typename T>
Geometry geometry(int TT, int Cin, int D2, int k, bool tc) {
  Geometry g;
  g.TT = TT;
  g.d0 = 1 << ((2 * k) % 5);
  g.d1 = 1 << ((2 * k + 1) % 5);
  g.R1 = TT + 2 * (g.d1 + 2);
  g.RX = g.R1 + 2 * g.d0;
  g.R2 = TT + 4;
  g.kx = tc ? round16(Cin) : Cin;
  g.ldx = tc ? g.kx + 16 : Cin;
  g.ldy = tc ? D2 + 16 : D2;
  const int x_rows = tc ? g.RX + round16(g.R1) - g.R1 : g.RX;
  const int y0_rows = tc ? g.R1 + round16(g.R2) - g.R2 : g.R1;
  const int y1_rows = tc ? round16(TT) + 4 : g.R2;
  const size_t xa = (size_t)x_rows * g.ldx, ya = (size_t)y1_rows * g.ldy;
  g.bufA = xa > ya ? xa : ya;
  g.y0 = (size_t)y0_rows * g.ldy;
  g.smem = (g.bufA + g.y0) * sizeof(T) + (tc ? kBChunks + kScratch : 2 * KC * CT * sizeof(T));
  return g;
}

// x window: times [t0 - h1 - d0, t0 + TT + h1 + d0), zero outside [0, T) and
// in the depth padding columns [Cin, kx); V-wide vector copies (V | Cin, V | kx)
template <int V, typename T>
__device__ void load_x_rows(const T* __restrict__ xb, T* bufA, const Geometry& geo, int t0,
                            int Tlen, int Cin) {
  using Vec = typename std::conditional<V * sizeof(T) == 16, uint4,
              typename std::conditional<V * sizeof(T) == 4, uint32_t, T>::type>::type;
  const int xt0 = t0 - (geo.d1 + 2) - geo.d0, nv = geo.kx / V;
  for (int i = threadIdx.x; i < geo.RX * nv; i += THREADS) {
    const int r = i / nv, c = (i % nv) * V, t = xt0 + r;
    Vec v;
    if (c < Cin && t >= 0 && t < Tlen) {
      v = *reinterpret_cast<const Vec*>(xb + (size_t)t * Cin + c);
    } else {
      memset(&v, 0, sizeof(Vec));
    }
    *reinterpret_cast<Vec*>(bufA + (size_t)r * geo.ldx + c) = v;
  }
}

template <typename T>
__device__ void load_x_window(const T* __restrict__ xb, T* bufA, const Geometry& geo, int t0,
                              int Tlen, int Cin) {
  constexpr int V16 = 16 / sizeof(T), V4 = 4 / sizeof(T) > 0 ? 4 / sizeof(T) : 1;
  if (Cin % V16 == 0 && geo.kx % V16 == 0 && geo.ldx % V16 == 0)
    load_x_rows<V16>(xb, bufA, geo, t0, Tlen, Cin);
  else if (Cin % V4 == 0 && geo.kx % V4 == 0 && geo.ldx % V4 == 0)
    load_x_rows<V4>(xb, bufA, geo, t0, Tlen, Cin);
  else
    load_x_rows<1>(xb, bufA, geo, t0, Tlen, Cin);
}

// ---- f32 path: CUDA cores ---------------------------------------------------

// acc[g][r][c] = sum_j sum_k in[(r + j*dil) * ld + k] * W[j][k][g*goff + c]
// for r < R, c < Cout, over the 3 taps. `in` is shared memory whose row r + j*dil
// holds the conv input at the tap's time; W is (3, Cin, Wcols) in device
// memory. NG = 2 computes the GLU's value and gate halves together. Calls
// epi(r, c, value, gate) once per output element.
template <typename T, int NG, typename Epi>
__device__ void conv_stage_fma(const T* in, int ld, int R, int Cin, int dil,
                               const T* __restrict__ W, int Wcols, int Cout, int goff,
                               T* w_s, const Epi& epi) {
  const int tid = threadIdx.x, tr = tid / 32, tc = tid % 32;
  for (int r0 = 0; r0 < R; r0 += RT) {
    int rows[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) rows[i] = min(r0 + tr * 4 + i, R - 1);  // masked rows re-read a valid row
    for (int c0 = 0; c0 < Cout; c0 += CT) {
      float acc[NG][4][4];
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[g][i][j] = 0.f;
      for (int tap = 0; tap < 3; ++tap) {
        for (int k0 = 0; k0 < Cin; k0 += KC) {
          __syncthreads();  // every thread is done reading the previous chunk
          for (int i = tid; i < NG * KC * CT; i += THREADS) {
            const int g = i / (KC * CT), rem = i % (KC * CT);
            const int k = k0 + rem / CT, c = c0 + rem % CT;
            w_s[i] = (k < Cin && c < Cout)
                         ? W[((size_t)tap * Cin + k) * Wcols + g * goff + c]
                         : from_f<T>(0.f);
          }
          __syncthreads();
          const int kmax = min(KC, Cin - k0);
          const T* a0 = in + (size_t)(rows[0] + tap * dil) * ld + k0;
          const T* a1 = in + (size_t)(rows[1] + tap * dil) * ld + k0;
          const T* a2 = in + (size_t)(rows[2] + tap * dil) * ld + k0;
          const T* a3 = in + (size_t)(rows[3] + tap * dil) * ld + k0;
          for (int kk = 0; kk < kmax; ++kk) {
            const float a[4] = {to_f(a0[kk]), to_f(a1[kk]), to_f(a2[kk]), to_f(a3[kk])};
#pragma unroll
            for (int g = 0; g < NG; ++g) {
              const T* wrow = w_s + g * KC * CT + kk * CT + tc;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float wv = to_f(wrow[32 * j]);
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[g][i][j] = fmaf(a[i], wv, acc[g][i][j]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + tr * 4 + i;
        if (r >= R) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tc + 32 * j;
          if (c < Cout) epi(r, c, acc[0][i][j], acc[NG - 1][i][j]);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_block_fma_kernel(const T* __restrict__ x, const T* __restrict__ w0,
                      const float* __restrict__ b0, const float* __restrict__ a0,
                      const T* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ a1, const T* __restrict__ w2,
                      const float* __restrict__ b2, T* __restrict__ out, int Tlen, int Cin,
                      int D2, int skip, Geometry geo) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);
  T* bufA = w_s + 2 * KC * CT;  // x window, then y1
  T* y0_s = bufA + geo.bufA;
  const int b = blockIdx.y, t0 = blockIdx.x * geo.TT, h1 = geo.d1 + 2;

  load_x_window(x + (size_t)b * Tlen * Cin, bufA, geo, t0, Tlen, Cin);
  __syncthreads();
  // y0 over times [t0 - h1, t0 + TT + h1): tap j reads x row r + j*d0
  conv_stage_fma<T, 1>(bufA, geo.ldx, geo.R1, Cin, geo.d0, w0, D2, D2, 0, w_s,
                       Epi0<T>{bufA, geo.ldx, geo.d0, skip, b0, a0, D2, y0_s, geo.ldy, t0 - h1, Tlen});
  __syncthreads();
  // y1 over times [t0 - 2, t0 + TT + 2): tap j reads y0 row r + j*d1
  conv_stage_fma<T, 1>(y0_s, geo.ldy, geo.R2, D2, geo.d1, w1, D2, D2, 0, w_s,
                       Epi1<T>{y0_s, geo.ldy, geo.d1, b1, a1, D2, bufA, t0 - 2, Tlen});
  __syncthreads();
  // out over times [t0, t0 + TT) within [0, T): tap j reads y1 row r + 2j
  conv_stage_fma<T, 2>(bufA, geo.ldy, min(geo.TT, Tlen - t0), D2, 2, w2, 2 * D2, D2, D2, w_s,
                       Epi2<T>{b2, D2, out + (size_t)b * Tlen * D2, t0});
}

// ---- bf16 path: tensor cores (warp-level mma) -------------------------------

// Copy rows [k0, k0 + KB) of tap `tap` of W, channels [c0, c0 + TN) (and the
// gate channels goff further on when NG = 2), into one weight-chunk buffer
// [NG][KB][LDB] with 16-byte asynchronous copies. Channels >= Cout are not
// copied: no warp reads them.
template <int NG>
__device__ void stage_weights(bf16* dst, const bf16* __restrict__ W, int K, int Wcols, int Cout,
                              int goff, int tap, int k0, int c0) {
  constexpr int SEGS = TN / 8;
  for (int i = threadIdx.x; i < NG * KB * SEGS; i += THREADS) {
    const int g = i / (KB * SEGS), rem = i % (KB * SEGS);
    const int kk = rem / SEGS, c = (rem % SEGS) * 8;
    if (c0 + c < Cout)
      __pipeline_memcpy_async(dst + ((size_t)g * KB + kk) * LDB + c,
                              W + ((size_t)tap * K + k0 + kk) * Wcols + g * goff + c0 + c, 16);
  }
}

// Same contract as conv_stage_fma with K (a multiple of 16) as the depth.
// The block walks (64-row, 320-channel) output tiles; warp w owns row
// fragments 2(w / 4) + {0, 1} and channel fragments w % 4 + 4f (f < MAXF) of
// each — up to 10 independent accumulators (20 with the GLU gate), so every
// staged weight fragment feeds two rows of fragments and every A fragment
// five channels of them. The weights stream through shared memory in 16-deep
// chunks, NSTAGE - 1 chunks ahead of the one being multiplied (cp.async ring,
// one barrier per chunk); A fragments are read in place from the activation
// buffer `in`, which has round16(R) + 2*dil rows. Row fragments that start at
// or past R are skipped; rows >= R inside the last one are computed and dropped.
template <int NG, typename Epi>
__device__ void conv_stage_tc(const bf16* in, int ld, int R, int K, int dil,
                              const bf16* __restrict__ W, int Wcols, int Cout, int goff,
                              bf16* wbuf, float* scratch, const Epi& epi) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / 4, wc = warp % 4;
  float* sc = scratch + (size_t)warp * 2 * 256;
  const int nk = K / 16, chunks = 3 * nk;
  constexpr size_t kBuf = (size_t)NG * KB * LDB;
  for (int r0 = 0; r0 < R; r0 += TR) {
    const int rw = r0 + wr * 16 * WRF;  // this warp's first row
    const bf16* a_base = in + (size_t)rw * ld;
    for (int c0 = 0; c0 < Cout; c0 += TN) {
      const int nfr = min(TN, Cout - c0) / 16;  // channel fragments in this tile
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NG][WRF][MAXF];
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int q = 0; q < WRF; ++q)
#pragma unroll
          for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(acc[g][q][f], 0.f);
#pragma unroll
      for (int p = 0; p < NSTAGE - 1; ++p) {
        if (p < chunks)
          stage_weights<NG>(wbuf + p * kBuf, W, K, Wcols, Cout, goff, p / nk, (p % nk) * KB, c0);
        __pipeline_commit();
      }
      for (int i = 0; i < chunks; ++i) {
        __pipeline_wait_prior(NSTAGE - 2);  // this thread's copies of chunk i have landed
        __syncthreads();  // everyone's have; everyone is done with chunk i - 1
        const int nxt = i + NSTAGE - 1;
        if (nxt < chunks)  // refill the buffer chunk i - 1 used
          stage_weights<NG>(wbuf + (nxt % NSTAGE) * kBuf, W, K, Wcols, Cout, goff, nxt / nk,
                            (nxt % nk) * KB, c0);
        __pipeline_commit();
        if (rw >= R) continue;  // both of this warp's row fragments lie past R
        const int tap = i / nk, k0 = (i % nk) * KB;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[WRF];
#pragma unroll
        for (int q = 0; q < WRF; ++q)
          if (rw + 16 * q < R)
            wmma::load_matrix_sync(a[q], a_base + (size_t)(16 * q + tap * dil) * ld + k0, ld);
        const bf16* b_chunk = wbuf + (i % NSTAGE) * kBuf;
#pragma unroll
        for (int f = 0; f < MAXF; ++f) {
          const int cf = wc + 4 * f;
          if (cf < nfr) {
#pragma unroll
            for (int g = 0; g < NG; ++g) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
              wmma::load_matrix_sync(bfr, b_chunk + (size_t)g * KB * LDB + cf * 16, LDB);
#pragma unroll
              for (int q = 0; q < WRF; ++q)
                if (rw + 16 * q < R) wmma::mma_sync(acc[g][q][f], a[q], bfr, acc[g][q][f]);
            }
          }
        }
      }
      __syncthreads();  // the next tile's first copies must not land in a buffer in use
#pragma unroll
      for (int q = 0; q < WRF; ++q) {
        if (rw + 16 * q >= R) continue;
#pragma unroll
        for (int f = 0; f < MAXF; ++f) {
          const int cf = wc + 4 * f;
          if (cf < nfr) {
#pragma unroll
            for (int g = 0; g < NG; ++g)
              wmma::store_matrix_sync(sc + g * 256, acc[g][q][f], 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
              const int r = rw + 16 * q + e / 16;
              if (r < R) epi(r, c0 + cf * 16 + e % 16, sc[e], sc[(NG - 1) * 256 + e]);
            }
            __syncwarp();
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
conv_block_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                     const float* __restrict__ b0, const float* __restrict__ a0,
                     const bf16* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ a1, const bf16* __restrict__ w2,
                     const float* __restrict__ b2, bf16* __restrict__ out, int Tlen, int Cin,
                     int D2, int skip, Geometry geo) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);
  bf16* wbuf = reinterpret_cast<bf16*>(smem + kScratch);
  bf16* bufA = reinterpret_cast<bf16*>(smem + kScratch + kBChunks);  // x window, then y1
  bf16* y0_s = bufA + geo.bufA;
  const int b = blockIdx.y, t0 = blockIdx.x * geo.TT, h1 = geo.d1 + 2;

  load_x_window(x + (size_t)b * Tlen * Cin, bufA, geo, t0, Tlen, Cin);
  __syncthreads();
  conv_stage_tc<1>(bufA, geo.ldx, geo.R1, geo.kx, geo.d0, w0, D2, D2, 0, wbuf, scratch,
                   Epi0<bf16>{bufA, geo.ldx, geo.d0, skip, b0, a0, D2, y0_s, geo.ldy, t0 - h1, Tlen});
  __syncthreads();
  conv_stage_tc<1>(y0_s, geo.ldy, geo.R2, D2, geo.d1, w1, D2, D2, 0, wbuf, scratch,
                   Epi1<bf16>{y0_s, geo.ldy, geo.d1, b1, a1, D2, bufA, t0 - 2, Tlen});
  __syncthreads();
  conv_stage_tc<2>(bufA, geo.ldy, min(geo.TT, Tlen - t0), D2, 2, w2, 2 * D2, D2, D2, wbuf,
                   scratch, Epi2<bf16>{b2, D2, out + (size_t)b * Tlen * D2, t0});
}

// ---- launch -------------------------------------------------------------------

template <typename T, bool TC, typename Kernel>
int launch(Kernel kernel, const void* x, const void* w0, const void* b0, const void* a0,
           const void* w1, const void* b1, const void* a1, const void* w2, const void* b2,
           void* out, int B, int Tlen, int Cin, int D2, int k, void* stream) {
  if (TC && D2 % 16 != 0) return (int)cudaErrorInvalidValue;
  // the widest time tile whose buffers fit in shared memory; bf16 starts at
  // 60 so that y1 (TT + 4 rows) fills one 64-row block tile exactly
  Geometry geo = geometry<T>(TC ? 60 : 64, Cin, D2, k, TC);
  while (geo.smem > kMaxSmem && geo.TT > 16) geo = geometry<T>(geo.TT - 16, Cin, D2, k, TC);
  if (geo.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tlen + geo.TT - 1) / geo.TT, B);
  kernel<<<grid, THREADS, geo.smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w0, (const float*)b0, (const float*)a0, (const T*)w1,
      (const float*)b1, (const float*)a1, (const T*)w2, (const float*)b2, (T*)out, Tlen, Cin,
      D2, k > 0 ? 1 : 0, geo);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, T, Cin), w0 (3, Cin, D2), w1 (3, D2, D2), w2 (3, D2, 2*D2), out (B, T, D2)
extern "C" int conv_block_fused_f32(const void* x, const void* w0, const void* b0,
                                    const void* a0, const void* w1, const void* b1,
                                    const void* a1, const void* w2, const void* b2, void* out,
                                    int B, int Tlen, int Cin, int D2, int k, void* stream) {
  return launch<float, false>(conv_block_fma_kernel<float>, x, w0, b0, a0, w1, b1, a1, w2, b2,
                              out, B, Tlen, Cin, D2, k, stream);
}

// as above in bf16, with w0 (3, round16(Cin), D2) zero-padded in depth and D2 % 16 == 0
extern "C" int conv_block_fused_bf16(const void* x, const void* w0, const void* b0,
                                     const void* a0, const void* w1, const void* b1,
                                     const void* a1, const void* w2, const void* b2, void* out,
                                     int B, int Tlen, int Cin, int D2, int k, void* stream) {
  return launch<bf16, true>(conv_block_tc_kernel, x, w0, b0, a0, w1, b1, a1, w2, b2, out, B,
                            Tlen, Cin, D2, k, stream);
}
