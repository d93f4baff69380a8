// All three weight gradients of a dilated k=3 'SAME' conv in one pass:
//   dW_j[ci, co] = sum_{b, t} x[b, t + (j - 1) d, ci] * g[b, t, co],  j = 0, 1, 2,
// with rows of x outside [0, T) read as zero (each recording zero-pads its own edges).
//
// Replaces the Pallas TPU kernel speech_decoding_tpu/ops/pallas/tap_conv.py
// (_tap_conv_dw_kernel through tap_conv_dw). There one (3, Cin, Cout) f32
// accumulator is carried across a sequential grid over batch rows. Hopper's
// blocks run in no fixed order, so here the batch rows are split across
// blocks (whole rows, so a shift never crosses a recording): block
// (co tile, ci tile, split s) sums its rows into its own f32 partial, and a
// second kernel adds the partials of the splits in a fixed order. The result
// is the same bits on every run (f32 atomicAdd would not be).
//
// What bounds it on an H100: operations. At the flagship (B*T = 23,040 rows,
// (Cin, Cout) in {(270, 320), (320, 320), (320, 640)}) one step's 15 launches
// do 2.81e11 FLOP (0.284 ms at 989 TFLOP/s bf16) and move ~0.1 GB (x and g
// read once, dW written once: ~0.03 ms). The design reads each x row window
// and g row once per block and reuses the g fragments for all three taps:
//   * bf16: each block walks 64-row time chunks of its recordings through a
//     two-stage ring in shared memory: a (64 + 2d) x 64 window of x and a
//     64 x 64 chunk of g, copied with cp.async (16-byte pieces where the
//     channel count allows, 4- or 2-byte ones otherwise) while the previous
//     chunk is multiplied; its 4 warps each own a 32 x 32 piece of the tile
//     for all three taps and run nvcuda::wmma 16x16x16 with f32
//     accumulation. xT is the A operand, so x's window is loaded as a
//     col-major A fragment; tap j starts j*d rows further down the window.
//   * f32: 32-row chunks staged synchronously, 4 x 4 outputs x 3 taps a
//     thread on the CUDA cores (the tests' and the card-vs-CPU check's path).
// Channels past Cin/Cout are zero-filled in shared memory (Cin = 270 is not a
// multiple of 16); the partials are padded to whole 64 x 64 tiles. When
// d >= T the shifted taps see no valid row and are written as zero.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaGetLastError() of the launches.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;  // f32 path and the reduction
constexpr int THREADS_B = 128;  // bf16 path: 4 warps of 32 x 32 outputs
constexpr int TI = 64;        // input channels per block
constexpr int TO = 64;        // output channels per block
constexpr int TK = 32;        // f32 path: time rows per chunk
constexpr int TKB = 64;       // bf16 path: time rows per chunk
constexpr int LD = TI + 16;   // bf16 row stride: 160 bytes keeps every row 32-byte aligned for wmma
constexpr int LDF = TI + 4;   // f32 row stride
constexpr size_t kMaxSmem = 232448;

// f32: rows x 64 channels of src (B, T, C) into dst (row stride LDF): row r
// is time t_first + r of recording b; rows outside [0, T) and channels >= C are zero
__device__ void load_rows(float* dst, const float* __restrict__ src, int b, int Tlen, int C, int t_first,
                          int rows, int c0) {
  for (int i = threadIdx.x; i < rows * TI; i += THREADS) {
    const int r = i / TI, c = i % TI, t = t_first + r, ch = c0 + c;
    dst[r * LDF + c] = (t >= 0 && t < Tlen && ch < C) ? src[((size_t)b * Tlen + t) * C + ch] : 0.f;
  }
}

struct Geo {
  int B, T, Cin, Cout, d, dd, nsplit, cin_pad, cout_pad;
};

__device__ __forceinline__ void split_rows(const Geo& g, int s, int& b0, int& b1) {
  b0 = (int)((long long)g.B * s / g.nsplit);
  b1 = (int)((long long)g.B * (s + 1) / g.nsplit);
}

// bf16: start copying rows x 64 channels of src (B, T, C) into dst (row
// stride LD): row r is time t_first + r of recording b. Rows outside [0, T)
// and channels >= C are zero-filled. VEC channels a copy: 8 (16 bytes) needs
// C % 8 == 0 and a 16-byte aligned src, 2 (4 bytes) C % 2 == 0; 1 stores
// synchronously.
template <int VEC>
__device__ __forceinline__ void copy_rows_async(bf16* dst, const bf16* __restrict__ src, int b, int Tlen, int C,
                                           int t_first, int rows, int c0) {
  constexpr int NV = TI / VEC;
  for (int i = threadIdx.x; i < rows * NV; i += THREADS_B) {
    const int r = i / NV, v = i % NV, t = t_first + r, ch = c0 + v * VEC;
    const bool ok = t >= 0 && t < Tlen && ch < C;
    const bf16* from = ok ? src + ((size_t)b * Tlen + t) * C + ch : src;
    bf16* to = dst + r * LD + v * VEC;
    if constexpr (VEC == 1) {
      *to = ok ? *from : __float2bfloat16(0.f);
    } else {
      __pipeline_memcpy_async(to, from, VEC * sizeof(bf16), ok ? 0 : VEC * sizeof(bf16));
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS_B)
tap_conv_dw_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g, float* __restrict__ part,
                        Geo geo) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const int win = TKB + 2 * geo.dd;
  const size_t stage = (size_t)(win + TKB) * LD;  // x window, then g chunk
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int co0 = blockIdx.x * TO, ci0 = blockIdx.y * TI, s = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int fi = (warp / 2) * 2;    // this warp's two 16-channel slices of the ci tile
  const int fo = (warp % 2) * 2;    // and of the co tile
  const bool shifted = geo.d < geo.T;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3][2][2];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int f = 0; f < 2; ++f) wmma::fill_fragment(acc[j][q][f], 0.f);

  int b0, b1;
  split_rows(geo, s, b0, b1);
  const int per_rec = (geo.T + TKB - 1) / TKB;
  const int chunks = (b1 - b0) * per_rec;
  auto start_copy = [&](int c) {
    const int b = b0 + c / per_rec, t0 = (c % per_rec) * TKB;
    bf16* xs = ring + (size_t)(c & 1) * stage;
    copy_rows_async<VEC>(xs, x, b, geo.T, geo.Cin, t0 - geo.dd, win, ci0);
    copy_rows_async<VEC>(xs + (size_t)win * LD, g, b, geo.T, geo.Cout, t0, TKB, co0);
    __pipeline_commit();
  };
  if (chunks > 0) start_copy(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      start_copy(c + 1);  // the other stage: its last reader passed the barrier at the end of c - 1
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const bf16* xs = ring + (size_t)(c & 1) * stage;
    const bf16* gs = xs + (size_t)win * LD;
#pragma unroll
    for (int kk = 0; kk < TKB; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> gb[2];
#pragma unroll
      for (int f = 0; f < 2; ++f) wmma::load_matrix_sync(gb[f], gs + kk * LD + (fo + f) * 16, LD);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j != 1 && !shifted) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> xa;
          wmma::load_matrix_sync(xa, xs + (kk + j * geo.dd) * LD + (fi + q) * 16, LD);
#pragma unroll
          for (int f = 0; f < 2; ++f) wmma::mma_sync(acc[j][q][f], xa, gb[f], acc[j][q][f]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float* pj = part + ((size_t)(s * 3 + j) * geo.cin_pad + ci0 + (fi + q) * 16) * geo.cout_pad + co0;
#pragma unroll
      for (int f = 0; f < 2; ++f)
        wmma::store_matrix_sync(pj + (fo + f) * 16, acc[j][q][f], geo.cout_pad, wmma::mem_row_major);
    }
}

__global__ void __launch_bounds__(THREADS)
tap_conv_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ part,
                       Geo geo) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int win = TK + 2 * geo.dd;
  float* xs = reinterpret_cast<float*>(smem);
  float* gs = xs + (size_t)win * LDF;
  const int co0 = blockIdx.x * TO, ci0 = blockIdx.y * TI, s = blockIdx.z;
  const int ti = threadIdx.x / 16;  // channels ci0 + ti*4 + i
  const int to = threadIdx.x % 16;  // channels co0 + to + 16*c (neighbouring threads, neighbouring words)
  const bool shifted = geo.d < geo.T;

  float acc[3][4][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][i][c] = 0.f;

  int b0, b1;
  split_rows(geo, s, b0, b1);
  for (int b = b0; b < b1; ++b) {
    for (int t0 = 0; t0 < geo.T; t0 += TK) {
      load_rows(xs, x, b, geo.T, geo.Cin, t0 - geo.dd, win, ci0);
      load_rows(gs, g, b, geo.T, geo.Cout, t0, TK, co0);
      __syncthreads();
      for (int kk = 0; kk < TK; ++kk) {
        float gv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) gv[c] = gs[kk * LDF + to + 16 * c];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          if (j != 1 && !shifted) continue;
          const float* xr = xs + (kk + j * geo.dd) * LDF + ti * 4;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float xv = xr[i];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[j][i][c] = fmaf(xv, gv[c], acc[j][i][c]);
          }
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = part + ((size_t)(s * 3 + j) * geo.cin_pad + ci0 + ti * 4 + i) * geo.cout_pad + co0;
#pragma unroll
      for (int c = 0; c < 4; ++c) row[to + 16 * c] = acc[j][i][c];
    }
}

// out[j, ci, co] = sum over splits s = 0, 1, ... of part[s, j, ci, co], in that order
__global__ void __launch_bounds__(THREADS)
reduce_splits_kernel(const float* __restrict__ part, float* __restrict__ out, Geo geo) {
  const size_t n = (size_t)3 * geo.Cin * geo.Cout;
  const size_t plane = (size_t)3 * geo.cin_pad * geo.cout_pad;
  for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < n; e += (size_t)gridDim.x * THREADS) {
    const int co = (int)(e % geo.Cout);
    const size_t r = e / geo.Cout;
    const int ci = (int)(r % geo.Cin), j = (int)(r / geo.Cin);
    const size_t off = ((size_t)j * geo.cin_pad + ci) * geo.cout_pad + co;
    float sum = 0.f;
    for (int s = 0; s < geo.nsplit; ++s) sum += part[s * plane + off];
    out[e] = sum;
  }
}

Geo geometry(int B, int Tlen, int Cin, int Cout, int d, int nsplit) {
  Geo geo;
  geo.B = B; geo.T = Tlen; geo.Cin = Cin; geo.Cout = Cout; geo.d = d;
  geo.dd = d < Tlen ? d : 0;
  geo.nsplit = nsplit;
  geo.cin_pad = (Cin + TI - 1) / TI * TI;
  geo.cout_pad = (Cout + TO - 1) / TO * TO;
  return geo;
}

// the dW kernel (given) on the grid of geo, then the fixed-order reduction
template <typename T>
int launch(void (*kernel)(const T*, const T*, float*, Geo), int threads, size_t smem, const void* x,
           const void* g, void* part, void* out, const Geo& geo, void* stream) {
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(geo.cout_pad / TO, geo.cin_pad / TI, geo.nsplit);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>((const T*)x, (const T*)g, (float*)part, geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int Cin = geo.Cin, Cout = geo.Cout;
  const size_t n = (size_t)3 * Cin * Cout;
  const int blocks = (int)((n + THREADS - 1) / THREADS < 1024 ? (n + THREADS - 1) / THREADS : 1024);
  reduce_splits_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>((const float*)part, (float*)out, geo);
  return (int)cudaGetLastError();
}

}  // namespace

// part: nsplit x 3 x round64(Cin) x round64(Cout) f32 scratch; out: 3 x Cin x Cout f32
extern "C" int tap_conv_dw_bf16(const void* x, const void* g, void* part, void* out, int B, int Tlen, int Cin,
                                int Cout, int d, int nsplit, void* stream) {
  const Geo geo = geometry(B, Tlen, Cin, Cout, d, nsplit);
  const size_t smem = 2 * (size_t)(TKB + 2 * geo.dd + TKB) * LD * sizeof(bf16);
  const bool a16 = (uintptr_t)x % 16 == 0 && (uintptr_t)g % 16 == 0;
  const bool a4 = (uintptr_t)x % 4 == 0 && (uintptr_t)g % 4 == 0;
  if (Cin % 8 == 0 && Cout % 8 == 0 && a16)
    return launch<bf16>(tap_conv_dw_bf16_kernel<8>, THREADS_B, smem, x, g, part, out, geo, stream);
  if (Cin % 2 == 0 && Cout % 2 == 0 && a4)
    return launch<bf16>(tap_conv_dw_bf16_kernel<2>, THREADS_B, smem, x, g, part, out, geo, stream);
  return launch<bf16>(tap_conv_dw_bf16_kernel<1>, THREADS_B, smem, x, g, part, out, geo, stream);
}

extern "C" int tap_conv_dw_f32(const void* x, const void* g, void* part, void* out, int B, int Tlen, int Cin,
                               int Cout, int d, int nsplit, void* stream) {
  const Geo geo = geometry(B, Tlen, Cin, Cout, d, nsplit);
  const size_t smem = (size_t)(TK + 2 * geo.dd + TK) * LDF * sizeof(float);
  return launch<float>(tap_conv_dw_f32_kernel, THREADS, smem, x, g, part, out, geo, stream);
}
