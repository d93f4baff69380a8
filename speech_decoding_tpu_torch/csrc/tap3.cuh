// The dilated 3-tap 'SAME' conv tile that K5 (tap_conv.cu), all six K6
// stages and K7 (conv_block_train.cu) are built on:
//   acc[b, t, g*Cout + c] = sum_j sum_k pro(x[b, t + (j - 1) d, k]) * W[j, k, g*goff + c]
// with rows of the (transformed) input outside [0, T) read as zero, f32
// accumulation, then a per-element epilogue that also yields up to two
// per-channel sums.
//
// Replaces the Pallas device primitive _conv3 (speech_decoding_tpu/ops/pallas/
// conv_block.py:50) and the body of tap_conv (ops/pallas/tap_conv.py:51). The
// Pallas kernels hold whole recordings and every weight in VMEM; w2 alone is
// 1.2 MB in bf16, far above the 227 KB of shared memory of an H100 block. So
// here one block of 128 threads computes a tile of TM = 64 times of one
// recording by TN = 64 output channels (two groups of 64 when NG = 2, the
// GLU's value and gate halves, so one thread sees both halves of an output).
// It walks the input channels in chunks: each chunk stages the input window
// (TM + 2d rows: the tile and a halo of d on each side, zero outside the
// recording) and the three taps' weight rows in shared memory. The input
// passes through a prologue on its way in (the identity, or BatchNorm then
// GELU when the conv reads a normalised activation that is never stored).
//   * bf16: nvcuda::wmma 16x16x16 with f32 accumulation; warp w owns rows
//     32(w / 2) + {0, 16} and columns 32(w % 2) + {0, 16} of each group; tap
//     j reads the window j*d rows further down.
//   * f32: CUDA-core FMA, 8 rows x 4 columns (per group) a thread.
// The accumulators then go through shared memory, so the epilogue sees one
// output column per thread (coalesced stores) and sums its rows in a fixed
// order; the block's per-channel sums are written to its own slot of a
// partial array, and reduce_parts adds the slots in a fixed order. No float
// atomics: two runs give the same bits.
//
// What bounds it on an H100: operations (2 * 3 * Cin * Cout per output row;
// a 320 -> 320 conv at B = 64, T = 360 is 14.2 GFLOP, 14 us at 989 TFLOP/s
// against ~30 MB of traffic, 9 us). This first version stages each chunk
// synchronously and is far from that bound; wgmma with TMA-fed tiles is the
// design that reaches it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace tap3 {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int TM = 64;  // output times per block
constexpr int TN = 64;  // output channels per block and group
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }
// v rounded to T (the identity for f32): one rounding of a PyTorch op in T
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }
// a read-only load (ld.global.nc) of what no kernel here writes while it
// runs, so the compiler may issue it ahead of the epilogue's earlier stores
template <typename T> __device__ __forceinline__ float ldg(const T* p) { return to_f(__ldg(p)); }

__device__ __forceinline__ float gelu(float v) { return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }

// d/du [u * Phi(u)] = Phi(u) + u * phi(u)
__device__ __forceinline__ float dgelu(float u) {
  const float cdf = 0.5f * (1.f + erff(u * 0.70710678118654752f));
  const float pdf = expf(-0.5f * u * u) * 0.39894228040143268f;
  return cdf + u * pdf;
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// BatchNorm applied in T from f32 statistics, one rounding per op as in
// PyTorch: mi (2, C) [mean; inv], gb (2, C) [scale; bias]. y is T-valued.
struct BnConst {
  float m, inv, scale, bias;  // channel c's, each rounded to T
};

template <typename T>
__device__ __forceinline__ BnConst bn_const(const float* mi, const float* gb, int C, int c) {
  return {rnd<T>(ldg(mi + c)), rnd<T>(ldg(mi + C + c)), rnd<T>(ldg(gb + c)), rnd<T>(ldg(gb + C + c))};
}

template <typename T>
__device__ __forceinline__ void bn_apply(float y, const BnConst& k, float& xhat, float& u) {
  xhat = rnd<T>(rnd<T>(y - k.m) * k.inv);
  u = rnd<T>(rnd<T>(xhat * k.scale) + k.bias);
}

template <typename T>
__device__ __forceinline__ void bn_apply(float y, int c, const float* mi, const float* gb, int C, float& xhat,
                                         float& u) {
  bn_apply<T>(y, bn_const<T>(mi, gb, C, c), xhat, u);
}

// GELU(BN(y)) rounded to T
template <typename T>
__device__ __forceinline__ float bn_gelu(float y, const BnConst& k) {
  float xhat, u;
  bn_apply<T>(y, k, xhat, u);
  return rnd<T>(gelu(u));
}

struct Ident {
  __device__ float operator()(float v, int) const { return v; }
};

// h = GELU(BN(y)) in T: the activation F2, F3 and B1 read but never store
template <typename T>
struct BnGelu {
  const float* mi;
  const float* gb;
  int C;
  __device__ float operator()(float y, int c) const { return bn_gelu<T>(y, bn_const<T>(mi, gb, C, c)); }
};

struct Conv {
  int B, T, Cin, Cout;  // x (B, T, Cin); Cout output channels per group
  int Wcols, goff;      // w (3, Cin, Wcols); group g reads columns g*goff + c
  int d, ntile;         // dilation; time tiles per recording
  int xvec, wvec;       // bf16: 16-byte loads of x rows / w rows are allowed
};

inline Conv make_conv(int B, int Tlen, int Cin, int Cout, int Wcols, int goff, int d, const void* x,
                      const void* w) {
  Conv g;
  g.B = B; g.T = Tlen; g.Cin = Cin; g.Cout = Cout; g.Wcols = Wcols; g.goff = goff; g.d = d;
  g.ntile = (Tlen + TM - 1) / TM;
  g.xvec = Cin % 8 == 0 && (uintptr_t)x % 16 == 0;
  g.wvec = Cout % 8 == 0 && Wcols % 8 == 0 && goff % 8 == 0 && (uintptr_t)w % 16 == 0;
  return g;
}

template <typename T, int NG>
struct Layout {
  static constexpr bool TC = sizeof(T) == 2;
  static constexpr int KC = TC ? 32 : 16;                 // input channels a chunk
  static constexpr int LDX = TC ? KC + 16 : KC + 1;       // bf16: 96-byte rows keep wmma's 32-byte alignment
  static constexpr int LDW = TC ? NG * TN + 16 : NG * TN;
  static constexpr int LDC = NG * TN + 4;
  __host__ __device__ static size_t xs_elems(int d) { return (size_t)(TM + 2 * d) * LDX; }
  __host__ __device__ static size_t stage_bytes(int d) {
    return ((xs_elems(d) + (size_t)3 * KC * LDW) * sizeof(T) + 127) / 128 * 128;
  }
  __host__ __device__ static size_t smem(int d) {
    return stage_bytes(d) + (size_t)TM * LDC * sizeof(float) + 4 * TN * sizeof(float);
  }
};

// The input window of chunk k0: row r is time t0 - d + r, channels k0 + [0, KC),
// through the prologue; zero outside [0, T) and past Cin. With `dump` set, the
// block of the first channel tile also writes its TM interior rows of the
// transformed input there ((B, T, Cin) in T).
template <typename T, int NG, class Pro>
__device__ void load_window(T* xs, const T* __restrict__ x, const Conv& g, const Pro& pro, int b, int t0,
                            int k0, T* dump) {
  using L = Layout<T, NG>;
  const int rows = TM + 2 * g.d;
  const T* xb = x + (size_t)b * g.T * g.Cin;
  const bool dumps = dump != nullptr && blockIdx.x == 0;
  if constexpr (L::TC) {
    if (g.xvec) {
      constexpr int NV = L::KC / 8;
      for (int i = threadIdx.x; i < rows * NV; i += THREADS) {
        const int r = i / NV, c = (i % NV) * 8, t = t0 - g.d + r, ch = k0 + c;
        uint4 out = make_uint4(0, 0, 0, 0);
        if (t >= 0 && t < g.T && ch < g.Cin) {  // Cin % 8 == 0: all 8 channels are in range
          const uint4 raw = *reinterpret_cast<const uint4*>(xb + (size_t)t * g.Cin + ch);
          const T* e = reinterpret_cast<const T*>(&raw);
          T* o = reinterpret_cast<T*>(&out);
#pragma unroll
          for (int q = 0; q < 8; ++q) o[q] = from_f<T>(pro(to_f(e[q]), ch + q));
          if (dumps && r >= g.d && r < g.d + TM)
            *reinterpret_cast<uint4*>(dump + ((size_t)b * g.T + t) * g.Cin + ch) = out;
        }
        *reinterpret_cast<uint4*>(xs + (size_t)r * L::LDX + c) = out;
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < rows * L::KC; i += THREADS) {
    const int r = i / L::KC, c = i % L::KC, t = t0 - g.d + r, ch = k0 + c;
    T v = from_f<T>(0.f);
    if (t >= 0 && t < g.T && ch < g.Cin) {
      v = from_f<T>(pro(to_f(xb[(size_t)t * g.Cin + ch]), ch));
      if (dumps && r >= g.d && r < g.d + TM) dump[((size_t)b * g.T + t) * g.Cin + ch] = v;
    }
    xs[(size_t)r * L::LDX + c] = v;
  }
}

// Weight rows k0 + [0, KC) of the three taps, columns n0 + [0, TN) of each
// group; zero past Cin and past Cout. Row j*KC + kk holds tap j, channel k0 + kk.
// Where Cout or Wcols is not a multiple of 8 (K5's dx of the 270-channel
// conv, K6's B3 at k = 0) every element is a load of its own: about 2.5x
// slower staging for those convs. Templating the piece width (8, 2 or 1)
// over both loaders raised the kernels to 168-178 registers and slowed
// every conv by ~1.6x (fewer blocks per SM), so the two paths stay.
template <typename T, int NG>
__device__ void load_weights(T* ws, const T* __restrict__ w, const Conv& g, int n0, int k0) {
  using L = Layout<T, NG>;
  constexpr int COLS = NG * TN;
  if constexpr (L::TC) {
    if (g.wvec) {
      constexpr int NV = COLS / 8;
      for (int i = threadIdx.x; i < 3 * L::KC * NV; i += THREADS) {
        const int row = i / NV, n = (i % NV) * 8;
        const int j = row / L::KC, k = k0 + row % L::KC, c = n0 + n % TN;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k < g.Cin && c < g.Cout)  // Cout % 8 == 0: all 8 columns are in range
          v = *reinterpret_cast<const uint4*>(w + ((size_t)j * g.Cin + k) * g.Wcols + (n / TN) * g.goff + c);
        *reinterpret_cast<uint4*>(ws + (size_t)row * L::LDW + n) = v;
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < 3 * L::KC * COLS; i += THREADS) {
    const int row = i / COLS, n = i % COLS;
    const int j = row / L::KC, k = k0 + row % L::KC, c = n0 + n % TN;
    ws[(size_t)row * L::LDW + n] = (k < g.Cin && c < g.Cout)
        ? w[((size_t)j * g.Cin + k) * g.Wcols + (n / TN) * g.goff + c] : from_f<T>(0.f);
  }
}

// K7's form of the tile: the accumulators of one TM x (NG * TN) output tile
// and the multiply of one staged chunk, acc += sum_j A_j W_j, where A_j's row
// r is row r + j*d of `a` (row stride lda: a staged window, or any (TM +
// 2d)-row array in shared memory) and W_j the chunk's tap-j weight rows staged
// by load_weights. It is conv3_kernel's loop, operation for operation (the
// same fragments, chunk walk, tap order and 16-deep steps), so K7 and the
// split K6 kernels give the same bits. conv3_kernel keeps its own inline
// copy: routed through this struct, K6's F1 kernel ran slower on the card.
template <typename T, int NG, bool TC = Layout<T, NG>::TC>
struct Tile;

template <typename T, int NG>
struct Tile<T, NG, true> {
  using L = Layout<T, NG>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[NG][2][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int f = 0; f < 2; ++f) nvcuda::wmma::fill_fragment(acc[q][i][f], 0.f);
  }

  __device__ __forceinline__ void mma(const T* a, int lda, const T* ws, int d) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int ks = 0; ks < L::KC; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], a + (size_t)(wr * 32 + i * 16 + j * d) * lda + ks, lda);
#pragma unroll
        for (int q = 0; q < NG; ++q)
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
            wmma::load_matrix_sync(bfr, ws + (size_t)(j * L::KC + ks) * L::LDW + q * TN + wc * 32 + f * 16, L::LDW);
#pragma unroll
            for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[q][i][f], af[i], bfr, acc[q][i][f]);
          }
      }
    }
  }

  // the tile to cs (TM rows of stride L::LDC; group q at columns q * TN)
  __device__ __forceinline__ void store(float* cs) {
    const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int f = 0; f < 2; ++f)
          nvcuda::wmma::store_matrix_sync(cs + (size_t)(wr * 32 + i * 16) * L::LDC + q * TN + wc * 32 + f * 16,
                                          acc[q][i][f], L::LDC, nvcuda::wmma::mem_row_major);
  }
};

template <typename T, int NG>
struct Tile<T, NG, false> {
  using L = Layout<T, NG>;
  float acc[NG][8][4];  // rows tr*8 + i, columns tc + 16*c of each group

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[q][i][c] = 0.f;
  }

  __device__ __forceinline__ void mma(const T* a, int lda, const T* ws, int d) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
    for (int j = 0; j < 3; ++j) {
      const T* xr = a + (size_t)(tr * 8 + j * d) * lda;
      const T* wr = ws + (size_t)j * L::KC * L::LDW + tc;
#pragma unroll 4
      for (int kk = 0; kk < L::KC; ++kk) {
        float av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = to_f(xr[i * lda + kk]);
#pragma unroll
        for (int q = 0; q < NG; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float wv = to_f(wr[kk * L::LDW + q * TN + 16 * c]);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[q][i][c] = fmaf(av[i], wv, acc[q][i][c]);
          }
      }
    }
  }

  __device__ __forceinline__ void store(float* cs) {
    const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) cs[(size_t)(tr * 8 + i) * L::LDC + q * TN + tc + 16 * c] = acc[q][i][c];
  }
};

// The conv of one tile (times t0 + [0, TM) of recording b, output columns n0
// + [0, TN) of each group) into cs, as conv3_kernel computes it: stage each
// chunk's input window and weight rows in xs and ws, multiply. Ends with cs
// written and synchronised.
template <typename T, int NG, class Pro>
__device__ __forceinline__ void conv3_tile(T* xs, T* ws, float* cs, const T* __restrict__ x, const T* __restrict__ w,
                                           const Conv& g, const Pro& pro, int b, int t0, int n0, T* dump) {
  using L = Layout<T, NG>;
  Tile<T, NG> tile;
  tile.zero();
  for (int k0 = 0; k0 < g.Cin; k0 += L::KC) {
    __syncthreads();  // everyone is done with the previous chunk
    load_window<T, NG>(xs, x, g, pro, b, t0, k0, dump);
    load_weights<T, NG>(ws, w, g, n0, k0);
    __syncthreads();
    tile.mma(xs, L::LDX, ws, g.d);
  }
  tile.store(cs);
  __syncthreads();
}

// Grid (ceil(Cout / TN), ntile, B). Epi: operator()(b, t, c, value, gate,
// s0, s1) for every output (b, t < T, c < Cout), and kStats: whether the
// block's per-channel sums s0, s1 go to part[(b * ntile + tile) * 2 * Cout + {0, Cout} + c].
template <typename T, int NG, class Pro, class Epi>
__global__ void __launch_bounds__(THREADS)
conv3_kernel(const T* __restrict__ x, const T* __restrict__ w, Conv g, Pro pro, Epi epi, float* __restrict__ part,
             T* dump) {
  using L = Layout<T, NG>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = xs + L::xs_elems(g.d);
  float* cs = reinterpret_cast<float*>(smem + L::stage_bytes(g.d));
  float* red = cs + TM * L::LDC;
  const int n0 = blockIdx.x * TN, t0 = blockIdx.y * TM, b = blockIdx.z;
  const int tid = threadIdx.x;

  if constexpr (L::TC) {
    using namespace nvcuda;
    const int warp = tid / 32, wr = warp / 2, wc = warp % 2;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NG][2][2];
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int f = 0; f < 2; ++f) wmma::fill_fragment(acc[q][i][f], 0.f);
    for (int k0 = 0; k0 < g.Cin; k0 += L::KC) {
      __syncthreads();  // everyone is done with the previous chunk
      load_window<T, NG>(xs, x, g, pro, b, t0, k0, dump);
      load_weights<T, NG>(ws, w, g, n0, k0);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 3; ++j) {
#pragma unroll
        for (int ks = 0; ks < L::KC; ks += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(a[i], xs + (size_t)(wr * 32 + i * 16 + j * g.d) * L::LDX + ks, L::LDX);
#pragma unroll
          for (int q = 0; q < NG; ++q)
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
              wmma::load_matrix_sync(bfr, ws + (size_t)(j * L::KC + ks) * L::LDW + q * TN + wc * 32 + f * 16, L::LDW);
#pragma unroll
              for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[q][i][f], a[i], bfr, acc[q][i][f]);
            }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int f = 0; f < 2; ++f)
          wmma::store_matrix_sync(cs + (size_t)(wr * 32 + i * 16) * L::LDC + q * TN + wc * 32 + f * 16, acc[q][i][f],
                                  L::LDC, wmma::mem_row_major);
  } else {
    const int tr = tid / 16, tc = tid % 16;  // rows tr*8 + i, columns tc + 16*q
    float acc[NG][8][4];
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[q][i][c] = 0.f;
    for (int k0 = 0; k0 < g.Cin; k0 += L::KC) {
      __syncthreads();
      load_window<T, NG>(xs, x, g, pro, b, t0, k0, dump);
      load_weights<T, NG>(ws, w, g, n0, k0);
      __syncthreads();
      for (int j = 0; j < 3; ++j) {
        const T* xr = xs + (size_t)(tr * 8 + j * g.d) * L::LDX;
        const T* wr = ws + (size_t)j * L::KC * L::LDW + tc;
#pragma unroll 4
        for (int kk = 0; kk < L::KC; ++kk) {
          float a[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = to_f(xr[i * L::LDX + kk]);
#pragma unroll
          for (int q = 0; q < NG; ++q)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float wv = to_f(wr[kk * L::LDW + q * TN + 16 * c]);
#pragma unroll
              for (int i = 0; i < 8; ++i) acc[q][i][c] = fmaf(a[i], wv, acc[q][i][c]);
            }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NG; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) cs[(size_t)(tr * 8 + i) * L::LDC + q * TN + tc + 16 * c] = acc[q][i][c];
  }
  __syncthreads();

  // epilogue: one output column a thread, half the tile's rows, in order
  const int c = tid % TN, h = tid / TN, co = n0 + c;
  float s0 = 0.f, s1 = 0.f;
  if (co < g.Cout) {
    for (int r = h * (TM / 2); r < (h + 1) * (TM / 2) && t0 + r < g.T; ++r)
      epi(b, t0 + r, co, cs[(size_t)r * L::LDC + c], cs[(size_t)r * L::LDC + (NG - 1) * TN + c], s0, s1);
  }
  if constexpr (Epi::kStats) {
    red[(h * 2) * TN + c] = s0;
    red[(h * 2 + 1) * TN + c] = s1;
    __syncthreads();
    if (h == 0 && co < g.Cout) {
      float* p = part + (size_t)(b * g.ntile + blockIdx.y) * 2 * g.Cout;
      p[co] = red[c] + red[2 * TN + c];
      p[g.Cout + co] = red[TN + c] + red[3 * TN + c];
    }
  }
}

// out[i] = sum over p = 0, 1, ... of part[p * n + i], in that order
__global__ void __launch_bounds__(256) reduce_parts(const float* __restrict__ part, float* __restrict__ out, int np,
                                                    int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < np; ++p) s += part[(size_t)p * n + i];
  out[i] = s;
}

inline int reduce(const float* part, float* out, int np, int n, cudaStream_t stream) {
  reduce_parts<<<(n + 255) / 256, 256, 0, stream>>>(part, out, np, n);
  return (int)cudaGetLastError();
}

template <typename T, int NG, class Pro, class Epi>
int launch_conv(const void* x, const void* w, const Conv& g, const Pro& pro, const Epi& epi, float* part,
                cudaStream_t stream, T* dump = nullptr) {
  using L = Layout<T, NG>;
  const size_t smem = L::smem(g.d);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = conv3_kernel<T, NG, Pro, Epi>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if ((long long)g.B * g.T == 0 || g.Cout == 0) return (int)cudaSuccess;
  const dim3 grid((g.Cout + TN - 1) / TN, g.ntile, g.B);
  kernel<<<grid, THREADS, smem, stream>>>((const T*)x, (const T*)w, g, pro, epi, part, dump);
  return (int)cudaGetLastError();
}

}  // namespace tap3
