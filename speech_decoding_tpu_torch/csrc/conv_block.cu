// One whole eval-mode ConvBlock:
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
// Neither fits the 227 KB of shared memory an H100 block can have.
//
// What bounds it on an H100: operations. For k >= 1 at B=64, T=360, D2=320 a
// block is 56.6 GFLOP against ~30 MB of input and output, i.e. ~57 us of bf16
// tensor-core time against ~10 us of memory time. Two paths:
//   * bf16 (the serving dtype, conv_block_fused_wg): three launches of
//     conv_wg (conv_wg.cuh, K6's bf16 body: persistent blocks, a four-stage
//     TMA ring, three consumer warpgroups on wgmma m64n160k16, 192 times x
//     160 columns a tile), one a conv, each with its own epilogue below on
//     the accumulator fragments. conv0 and conv1 store h0 and h1, the GELU
//     outputs rounded once to bf16, as (B, T, D2) tensors that the next conv
//     reads back through its tensor map; the map's zero fill outside [0, T)
//     is each conv's own 'SAME' padding, so no halo is recomputed. conv2
//     reads w2 packed with channel c's value and gate columns side by side,
//     so one thread holds both halves of the GLU and rounds its product
//     once. Traffic against the single-launch design: h0 and h1 written and
//     read back (4 * B*T*D2 bf16, ~59 MB at B=64, ~18 us at the card's
//     memory rate), against the halo recompute it replaces (conv0 over TT +
//     2(d1 + 2) + 2 d0 rows for every TT = 60). Needs D2 % 8 == 0, x's
//     channels zero-padded to a multiple of 8 (the wrapper copies block 0's
//     270 to 272) and K-major weights (prepare_fused_stack stages them).
//   * f32: one launch on the CUDA cores. Each thread block takes one (batch
//     row, tile of TT output times) and recomputes a halo: y0 over the tile
//     widened by d1 + 2 on each side, y1 over the tile widened by 2, then the
//     GLU output on the tile. The x window (widened by d0 + d1 + 2) and y0
//     live in shared memory, y1 overwrites the x window once conv0 is done;
//     rows whose time falls outside [0, T) are set to zero before the next
//     conv reads them. f32 FMA, 4x4 register tile per thread, weights staged
//     through shared memory in 32 x 128 chunks.
//
// C interface (ctypes): pointers and the stream as void*, returns the first
// non-zero cudaError_t of its launches (or of a shared-memory attribute call).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "conv_wg.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int RT = 32;   // f32 path: output rows per register tile (8 warps x 4 rows)
constexpr int CT = 128;  // f32 path: output channels per register tile (32 lanes x 4)
constexpr int KC = 32;   // f32 path: contraction chunk staged in shared memory
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most one H100 block may use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// ---- f32 path: epilogues -------------------------------------------------------

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

// ---- f32 path: block geometry ------------------------------------------------

struct Geometry {
  int TT, d0, d1, RX, R1, R2;  // time tile; dilations; x-window, y0 and y1 rows
  int ldx, ldy;                // row strides of the x window and of y0/y1
  size_t bufA, y0, smem;       // element counts of the two activation buffers, bytes in all
};

// rows exactly as needed, unpadded strides, a weight chunk of 32 x 128
template <typename T>
Geometry geometry(int TT, int Cin, int D2, int k) {
  Geometry g;
  g.TT = TT;
  g.d0 = 1 << ((2 * k) % 5);
  g.d1 = 1 << ((2 * k + 1) % 5);
  g.R1 = TT + 2 * (g.d1 + 2);
  g.RX = g.R1 + 2 * g.d0;
  g.R2 = TT + 4;
  g.ldx = Cin;
  g.ldy = D2;
  const size_t xa = (size_t)g.RX * g.ldx, ya = (size_t)g.R2 * g.ldy;
  g.bufA = xa > ya ? xa : ya;
  g.y0 = (size_t)g.R1 * g.ldy;
  g.smem = (g.bufA + g.y0) * sizeof(T) + 2 * KC * CT * sizeof(T);
  return g;
}

// x window: times [t0 - h1 - d0, t0 + TT + h1 + d0), zero outside [0, T);
// V-wide vector copies (V | Cin)
template <int V, typename T>
__device__ void load_x_rows(const T* __restrict__ xb, T* bufA, const Geometry& geo, int t0,
                            int Tlen, int Cin) {
  using Vec = typename std::conditional<V * sizeof(T) == 16, uint4,
              typename std::conditional<V * sizeof(T) == 4, uint32_t, T>::type>::type;
  const int xt0 = t0 - (geo.d1 + 2) - geo.d0, nv = Cin / V;
  for (int i = threadIdx.x; i < geo.RX * nv; i += THREADS) {
    const int r = i / nv, c = (i % nv) * V, t = xt0 + r;
    Vec v;
    if (t >= 0 && t < Tlen) {
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
  if (Cin % V16 == 0)
    load_x_rows<V16>(xb, bufA, geo, t0, Tlen, Cin);
  else if (Cin % V4 == 0)
    load_x_rows<V4>(xb, bufA, geo, t0, Tlen, Cin);
  else
    load_x_rows<1>(xb, bufA, geo, t0, Tlen, Cin);
}

// ---- f32 path: the kernel ---------------------------------------------------

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

// ---- bf16 path: three launches of conv_wg (conv_wg.cuh) ----------------------

// conv0: h0 = bf16(GELU((acc + b0 [+ x]) * a0[0] + a0[1])); with the skip
// (k > 0) x has D2 channels
struct WgEpi0 {
  static constexpr bool kStats = false, kUnguarded = true;
  const bf16* skip; const float* b0; const float* a0; bf16* h0; int T_, C;
  __device__ void operator()(int b, int t, int c, float v, float, float&, float&) const {
    const size_t i = ((size_t)b * T_ + t) * C + c;
    v += __ldg(b0 + c);
    if (skip) v += to_f(__ldg(skip + i));
    h0[i] = from_f<bf16>(gelu(v * __ldg(a0 + c) + __ldg(a0 + C + c)));
  }
};

// conv1: h1 = bf16(GELU((acc + b1 + h0) * a1[0] + a1[1])), the skip read
// from the stored, rounded h0 (the conv's own input)
struct WgEpi1 {
  static constexpr bool kStats = false, kUnguarded = true;
  const bf16* h0; const float* b1; const float* a1; bf16* h1; int T_, C;
  __device__ void operator()(int b, int t, int c, float v, float, float&, float&) const {
    const size_t i = ((size_t)b * T_ + t) * C + c;
    v += __ldg(b1 + c);
    v += to_f(__ldg(h0 + i));
    h1[i] = from_f<bf16>(gelu(v * __ldg(a1 + c) + __ldg(a1 + C + c)));
  }
};

// conv2: out = bf16((a + b2[c]) * sigmoid(g + b2[C + c])), one rounding
struct WgEpi2 {
  static constexpr bool kStats = false, kUnguarded = true;
  const float* b2; bf16* out; int T_, C;
  __device__ void operator()(int b, int t, int c, float a, float g, float&, float&) const {
    a += __ldg(b2 + c);
    g += __ldg(b2 + C + c);
    out[((size_t)b * T_ + t) * C + c] = from_f<bf16>(a * (1.f / (1.f + expf(-g))));
  }
};

int block_wg(const void* x, const void* w0k, const void* b0, const void* a0, const void* w1k, const void* b1,
             const void* a1, const void* w2g, const void* b2, void* h0, void* h1, void* out, int B, int Tlen,
             int cin_ld, int D2, int k, int sms, cudaStream_t st) {
  if (D2 % 8 != 0 || cin_ld % 8 != 0 || (k > 0 && cin_ld != D2)) return (int)cudaErrorInvalidValue;
  const int d0 = 1 << ((2 * k) % 5), d1 = 1 << ((2 * k + 1) % 5);
  const float *fb0 = (const float*)b0, *fa0 = (const float*)a0, *fb1 = (const float*)b1, *fa1 = (const float*)a1;
  CHECK((conv_wg<1>(x, cin_ld, w0k, WgEpi0{k > 0 ? (const bf16*)x : nullptr, fb0, fa0, (bf16*)h0, Tlen, D2},
                    nullptr, B, Tlen, D2, d0, sms, st)));
  CHECK((conv_wg<1>(h0, D2, w1k, WgEpi1{(const bf16*)h0, fb1, fa1, (bf16*)h1, Tlen, D2}, nullptr, B, Tlen, D2, d1,
                    sms, st)));
  return conv_wg<2>(h1, D2, w2g, WgEpi2{(const float*)b2, (bf16*)out, Tlen, D2}, nullptr, B, Tlen, D2, 2, sms, st);
}

// ---- f32 path: launch ---------------------------------------------------------

int launch_f32(const void* x, const void* w0, const void* b0, const void* a0, const void* w1, const void* b1,
               const void* a1, const void* w2, const void* b2, void* out, int B, int Tlen, int Cin, int D2, int k,
               cudaStream_t st) {
  // the widest time tile whose buffers fit in shared memory
  Geometry geo = geometry<float>(64, Cin, D2, k);
  while (geo.smem > kMaxSmem && geo.TT > 16) geo = geometry<float>(geo.TT - 16, Cin, D2, k);
  if (geo.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = conv_block_fma_kernel<float>;
  CHECK((int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem));
  const dim3 grid((Tlen + geo.TT - 1) / geo.TT, B);
  kernel<<<grid, THREADS, geo.smem, st>>>((const float*)x, (const float*)w0, (const float*)b0, (const float*)a0,
                                          (const float*)w1, (const float*)b1, (const float*)a1, (const float*)w2,
                                          (const float*)b2, (float*)out, Tlen, Cin, D2, k > 0 ? 1 : 0, geo);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, T, Cin), w0 (3, Cin, D2), w1 (3, D2, D2), w2 (3, D2, 2*D2), out (B, T, D2), all f32
extern "C" int conv_block_fused_f32(const void* x, const void* w0, const void* b0,
                                    const void* a0, const void* w1, const void* b1,
                                    const void* a1, const void* w2, const void* b2, void* out,
                                    int B, int Tlen, int Cin, int D2, int k, void* stream) {
  return launch_f32(x, w0, b0, a0, w1, b1, a1, w2, b2, out, B, Tlen, Cin, D2, k, (cudaStream_t)stream);
}

// bf16, D2 % 8 == 0: x (B, T, cin_ld) with its channels zero-padded to
// cin_ld (a multiple of 8; cin_ld == D2 for k > 0); the K-major weights
// w0k (3, D2, cin_ld), w1k (3, D2, D2) and w2g (3, 2*D2, D2) with channel
// c's value and gate columns at rows 2c and 2c + 1 (wk[j, n, ci] =
// W_j[ci, n]); h0, h1 (B, T, D2) scratch for the GELU outputs; out (B, T,
// D2); x and every weight 16-byte aligned; biases b0, b1 (D2,), b2 (2*D2,)
// and affines a0, a1 (2, D2) f32; sms: the card's SM count
extern "C" int conv_block_fused_wg(const void* x, const void* w0k, const void* b0, const void* a0,
                                   const void* w1k, const void* b1, const void* a1, const void* w2g,
                                   const void* b2, void* h0, void* h1, void* out, int B, int Tlen,
                                   int cin_ld, int D2, int k, int sms, void* stream) {
  return block_wg(x, w0k, b0, a0, w1k, b1, a1, w2g, b2, h0, h1, out, B, Tlen, cin_ld, D2, k, sms,
                  (cudaStream_t)stream);
}
