// Per-subject 1x1 conv: out[b] = x[b] @ W[sidx[b]], no gathered weight copy.
//
// Replaces the Pallas TPU kernel speech_decoding_tpu/ops/pallas/subject_conv.py
// (_subject_matmul_kernel through _subject_matmul_fwd, forward only). There a
// scalar-prefetched subject id picks each row's (D_in, D_out) weight block in
// the BlockSpec index map; here every thread block reads sidx[b] itself and
// copies that subject's weights from device memory (L2 holds all S blocks).
//
// What bounds it on an H100: bytes. At the serving shape (B=64, T=360,
// D=270, S=27, bf16) the function moves ~29 MB (x in, out, the weights once)
// for 3.4 GFLOP, so the memory time (~9 us at 3.35 TB/s) is above the
// tensor-core time. Two paths:
//   * bf16 (the serving dtype): one block per (row b, 64 times, up to 320
//     output channels) copies its x tile and W[s] whole into shared memory
//     (cp.async; depth and channels zero-padded to multiples of 16), then
//     runs warp-level mma (nvcuda::wmma 16x16x16, f32 accumulation): each
//     warp owns 2 x 5 output fragments. Needs D_in <= ~560 to fit.
//   * f32: a shared-memory tiled GEMM on the CUDA cores (32 x 128 tile per
//     block, depth in chunks of 32, f32 FMA).
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaGetLastError() of the launch. The caller checks ids are in [0, S).

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TM = 32;       // f32 path: time rows per block (8 warps x 4 rows)
constexpr int TN = 128;      // f32 path: output channels per block (32 lanes x 4)
constexpr int TK = 32;       // f32 path: contraction chunk staged in shared memory
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TT_TC = 64;    // bf16 path: time rows per block (4 row fragments, 2 per warp)
constexpr int MAXF = 5;      // bf16 path: channel fragments per warp (4 warps across)
constexpr int TN_TC = 16 * 4 * MAXF;  // bf16 path: output channels per block (320)
constexpr size_t kScratch = (size_t)WARPS * 256 * sizeof(float);
constexpr size_t kMaxSmem = 232448;  // 227 KB: the most one H100 block may use

__global__ void __launch_bounds__(THREADS)
subject_matmul_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const int32_t* __restrict__ sidx, float* __restrict__ out,
                          int Tlen, int Din, int Dout) {
  __shared__ float xs[TM][TK + 1];
  __shared__ float ws[TK][TN];
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * TM;
  const int c0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int tr = tid / 32;  // rows t0 + tr*4 + i      (all lanes of a warp share them)
  const int tc = tid % 32;  // cols c0 + tc + 32*j     (neighbouring lanes, neighbouring words)
  const float* xb = x + (size_t)b * Tlen * Din;
  const float* wb = w + (size_t)sidx[b] * Din * Dout;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Din; k0 += TK) {
    for (int i = tid; i < TM * TK; i += THREADS) {
      const int r = i / TK, kk = i % TK, t = t0 + r, k = k0 + kk;
      xs[r][kk] = (t < Tlen && k < Din) ? xb[(size_t)t * Din + k] : 0.f;
    }
    for (int i = tid; i < TK * TN; i += THREADS) {
      const int kk = i / TN, cc = i % TN, k = k0 + kk, c = c0 + cc;
      ws[kk][cc] = (k < Din && c < Dout) ? wb[(size_t)k * Dout + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[tr * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[kk][tc + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* ob = out + (size_t)b * Tlen * Dout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + tr * 4 + i;
    if (t >= Tlen) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc + 32 * j;
      if (c < Dout) ob[(size_t)t * Dout + c] = acc[i][j];
    }
  }
}

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// rows x cols bf16 from src (row stride lds) into dst (row stride ldd), rows
// past `rows` of the source and columns past `cols` left for the caller to
// zero; asynchronous 16- or 4-byte copies where the alignment allows
__device__ void copy_tile(bf16* dst, int ldd, const bf16* __restrict__ src, size_t lds, int rows,
                          int cols, bool v16, bool v4) {
  if (v16) {
    const int nv = cols / 8;
    for (int i = threadIdx.x; i < rows * nv; i += THREADS)
      __pipeline_memcpy_async(dst + (size_t)(i / nv) * ldd + (i % nv) * 8,
                              src + (i / nv) * lds + (i % nv) * 8, 16);
  } else if (v4) {
    const int nv = cols / 2;
    for (int i = threadIdx.x; i < rows * nv; i += THREADS)
      __pipeline_memcpy_async(dst + (size_t)(i / nv) * ldd + (i % nv) * 2,
                              src + (i / nv) * lds + (i % nv) * 2, 4);
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += THREADS)
      dst[(size_t)(i / cols) * ldd + i % cols] = src[(i / cols) * lds + i % cols];
  }
}

__device__ void zero_tile(bf16* dst, int ldd, int r0, int r1, int c0, int c1) {
  const int w = c1 - c0;
  if (w <= 0) return;
  for (int i = threadIdx.x; i < (r1 - r0) * w; i += THREADS)
    dst[(size_t)(r0 + i / w) * ldd + c0 + i % w] = __float2bfloat16(0.f);
}

struct TcGeometry {
  int kp, np, ldx, ldw;  // padded depth and channel count; row strides of the x and W tiles
  size_t smem;
};

inline TcGeometry tc_geometry(int Din, int Dout) {
  TcGeometry g;
  g.kp = round16(Din);
  g.np = round16(Dout < TN_TC ? Dout : TN_TC);
  g.ldx = g.kp + 8;  // +8: the 8 rows of an 8x8 fragment piece start in 8 distinct 16-byte bank groups
  g.ldw = g.np + 8;
  g.smem = kScratch + ((size_t)TT_TC * g.ldx + (size_t)g.kp * g.ldw) * sizeof(bf16);
  return g;
}

__global__ void __launch_bounds__(THREADS)
subject_matmul_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const int32_t* __restrict__ sidx, bf16* __restrict__ out, int Tlen,
                         int Din, int Dout, TcGeometry geo) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);
  bf16* xs = reinterpret_cast<bf16*>(smem + kScratch);
  bf16* ws = xs + (size_t)TT_TC * geo.ldx;
  const int b = blockIdx.z, t0 = blockIdx.y * TT_TC, c0 = blockIdx.x * TN_TC;
  const int rows = min(TT_TC, Tlen - t0), cols = min(TN_TC, Dout - c0);
  const bool x16 = Din % 8 == 0, x4 = Din % 2 == 0;
  const bool w16 = Dout % 8 == 0 && cols % 8 == 0, w4 = Dout % 2 == 0 && cols % 2 == 0;

  copy_tile(xs, geo.ldx, x + ((size_t)b * Tlen + t0) * Din, Din, rows, Din, x16, x4);
  copy_tile(ws, geo.ldw, w + (size_t)sidx[b] * Din * Dout + c0, Dout, Din, cols, w16, w4);
  __pipeline_commit();
  zero_tile(xs, geo.ldx, 0, rows, Din, geo.kp);        // depth padding
  zero_tile(xs, geo.ldx, rows, TT_TC, 0, geo.kp);      // times past T
  zero_tile(ws, geo.ldw, 0, Din, cols, geo.np);        // channel padding
  zero_tile(ws, geo.ldw, Din, geo.kp, 0, geo.np);      // depth padding
  __pipeline_wait_prior(0);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / 4, wc = warp % 4, nfr = geo.np / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][MAXF];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int f = 0; f < MAXF; ++f) wmma::fill_fragment(acc[q][f], 0.f);
  for (int k0 = 0; k0 < geo.kp; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
      wmma::load_matrix_sync(a[q], xs + (size_t)(wr * 32 + q * 16) * geo.ldx + k0, geo.ldx);
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      const int cf = wc + 4 * f;
      if (cf < nfr) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr;
        wmma::load_matrix_sync(bfr, ws + (size_t)k0 * geo.ldw + cf * 16, geo.ldw);
#pragma unroll
        for (int q = 0; q < 2; ++q) wmma::mma_sync(acc[q][f], a[q], bfr, acc[q][f]);
      }
    }
  }
  float* sc = scratch + (size_t)warp * 256;
  bf16* ob = out + (size_t)b * Tlen * Dout;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      const int cf = wc + 4 * f;
      if (cf < nfr) {
        wmma::store_matrix_sync(sc, acc[q][f], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = wr * 32 + q * 16 + e / 16, c = cf * 16 + e % 16;
          if (r < rows && c < cols) ob[(size_t)(t0 + r) * Dout + c0 + c] = __float2bfloat16(sc[e]);
        }
        __syncwarp();
      }
    }
  }
}

int launch_f32(const void* x, const void* w, const void* sidx, void* out, int B, int Tlen,
               int Din, int Dout, void* stream) {
  const dim3 grid((Dout + TN - 1) / TN, (Tlen + TM - 1) / TM, B);
  subject_matmul_f32_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const int32_t*)sidx, (float*)out, Tlen, Din, Dout);
  return (int)cudaGetLastError();
}

int launch_tc(const void* x, const void* w, const void* sidx, void* out, int B, int Tlen, int Din,
              int Dout, void* stream) {
  const TcGeometry geo = tc_geometry(Din, Dout);
  if (geo.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(subject_matmul_tc_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Dout + TN_TC - 1) / TN_TC, (Tlen + TT_TC - 1) / TT_TC, B);
  subject_matmul_tc_kernel<<<grid, THREADS, geo.smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (const int32_t*)sidx, (bf16*)out, Tlen, Din, Dout, geo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int subject_matmul_f32(const void* x, const void* w, const void* sidx, void* out,
                                  int B, int Tlen, int Din, int Dout, void* stream) {
  return launch_f32(x, w, sidx, out, B, Tlen, Din, Dout, stream);
}

extern "C" int subject_matmul_bf16(const void* x, const void* w, const void* sidx, void* out,
                                   int B, int Tlen, int Din, int Dout, void* stream) {
  return launch_tc(x, w, sidx, out, B, Tlen, Din, Dout, stream);
}
