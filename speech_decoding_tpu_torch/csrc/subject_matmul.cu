// Per-subject 1x1 conv: out[b] = x[b] @ W[sidx[b]], no gathered weight copy.
//
// Replaces the Pallas TPU kernel speech_decoding_tpu/ops/pallas/subject_conv.py
// (_subject_matmul_kernel through _subject_matmul_fwd). There a
// scalar-prefetched subject id picks each row's (D_in, D_out) weight block in
// the BlockSpec index map; here every thread block reads sidx[b] itself. The
// backward's dX is the same product on the transposed weights, as the JAX
// _bwd calls _subject_matmul_fwd on swapaxes(w).
//
// What bounds it on an H100: bytes. At the serving shape (B=64, T=360,
// D=270, S=27, bf16) the function moves ~29 MB (x in, out, the weights once)
// for 3.4 GFLOP, so the memory time (~8.5 us at 3.35 TB/s) is above the
// tensor-core time (~3.4 us). Three bodies:
//   * bf16 on Hopper (subject_matmul_wg_bf16, the serving and training
//     route): a block owns one recording's run of 64-row tiles (two runs a
//     recording at B=64, so 128 blocks fill the card in one wave). One
//     producer thread brings that subject's weights into shared memory once,
//     one 148 KB bulk copy of an image the wrapper packs
//     (subject_matmul_pack_bf16: 272 x 272 as 8 x 8 core matrices, K-major,
//     zero past D_in and D_out), and streams
//     the x tiles through a two-stage ring. A 270-channel row is 540 bytes,
//     too narrow a stride for a tensor map, so x is read where it lies: a
//     tile's rows are one contiguous run, moved by one 1-D bulk copy (a
//     multiple of 16 bytes at a 16-byte aligned start whenever T * D_in %
//     8 == 0). Two consumer warpgroups each take 136 of the 272 output
//     channels of a tile: A comes from that unswizzled tile into registers
//     (32-bit shared loads, columns past D_in zeroed), B from the weight
//     image, wgmma m64n136k16 with f32 accumulation, one rounding to bf16 as
//     each pair of channels is stored. The wrapper sends other shapes to the
//     next body (ops/subject_conv.py: _fast_path).
//   * bf16, any shape (subject_matmul_bf16): one block per (row b, 64
//     times, up to 320 output channels) copies its x tile and W[s] whole
//     into shared memory (cp.async; depth and channels zero-padded to
//     multiples of 16), then runs warp-level mma (nvcuda::wmma 16x16x16, f32
//     accumulation): each warp owns 2 x 5 output fragments. Needs D_in <=
//     ~560 to fit.
//   * f32: a shared-memory tiled GEMM on the CUDA cores (32 x 128 tile per
//     block, depth in chunks of 32, f32 FMA).
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaGetLastError() of the launch. The caller checks ids are in [0, S).
// The shared-memory attribute of each bf16 body is set once a process.

#include "hopper.cuh"

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
  static bool attr = false;  // the most a block may use, set once
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(subject_matmul_tc_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const dim3 grid((Dout + TN_TC - 1) / TN_TC, (Tlen + TT_TC - 1) / TT_TC, B);
  subject_matmul_tc_kernel<<<grid, THREADS, geo.smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (const int32_t*)sidx, (bf16*)out, Tlen, Din, Dout, geo);
  return (int)cudaGetLastError();
}

// ---- bf16 on Hopper: weights resident, x tiles by bulk copy, wgmma with A from registers ----
namespace wg {
constexpr int TM = 64;                  // times a tile (one wgmma m64)
constexpr int HALF = 136;               // output channels a consumer warpgroup (wgmma n)
constexpr int NP = 2 * HALF;            // output channels the image holds (272)
constexpr int GROUPS = NP / 8;          // 8-channel row groups of a reduction step (34)
constexpr int STEP_BYTES = GROUPS * 256;  // one 16-deep step: 34 groups x 2 core matrices x 128 bytes
constexpr int STEPS = 17;               // 16-deep reduction steps: D_in <= 272, zero past D_in
constexpr int MAX_DIN = 16 * STEPS;
constexpr int W_BYTES = STEPS * STEP_BYTES;  // one subject's image: 147,968 bytes
constexpr int STAGES = 2;               // x tiles in flight
constexpr int THREADS = 2 * 128 + 32;   // two consumer warpgroups, then one producer warp
constexpr size_t MAX_SMEM =
    (size_t)W_BYTES + (size_t)STAGES * TM * MAX_DIN * 2 + (2 * STAGES + 1) * sizeof(uint64_t);
}  // namespace wg

// two bf16 of x at (row r, columns k, k + 1) of a tile with row stride Din
// (even), zero past D_in (a select, not a branch: the products stay in one
// uniform sequence)
__device__ __forceinline__ uint32_t x_pair(const bf16* xt, int r, int k, int Din) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(xt + (size_t)r * Din + min(k, Din - 2));
  return k < Din ? v : 0u;
}

// Block i takes recording i / chunks, tiles [c * per, min(tiles, (c + 1) *
// per)) of it for c = i % chunks. Weights: image (S, 17, 34, 2, 8, 8) of
// [s, j, g, h, r, e] = W[s][16j + 8h + e][8g + r] (zero outside), so step j
// of a subject is one contiguous 8,704-byte piece and each core matrix 128
// contiguous bytes: K-major without swizzling, leading offset 128 (the next
// 8 of the reduction), stride offset 256 (the next 8 channels).
__global__ void __launch_bounds__(wg::THREADS, 1)
subject_matmul_wg_kernel(const bf16* __restrict__ x, const unsigned char* __restrict__ wimg,
                         const int32_t* __restrict__ sidx, bf16* __restrict__ out, int Tlen, int Din, int Dout,
                         int tiles, int per, int chunks) {
  using namespace wg;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* wsm = smem;
  const int ld = max(Din, Dout);  // a stage holds a tile of x, then the tile of out
  bf16* xs = reinterpret_cast<bf16*>(smem + W_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + W_BYTES + (size_t)STAGES * wg::TM * ld * 2);
  uint64_t* empty = full + STAGES;
  uint64_t* wbar = empty + STAGES;
  const int b = blockIdx.x / chunks, lo = blockIdx.x % chunks * per;
  const int n = min(tiles, lo + per) - lo;
  const int grp = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 1);  // the thread that stores the tile, once its copy has read it
    }
    hopper::mbar_init(wbar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (grp == 2) {  // producer warp: one thread issues every copy
    if (threadIdx.x == 256) {
      const bf16* xb = x + (size_t)b * Tlen * Din;
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) hopper::mbar_wait(&empty[st], (i / STAGES - 1) & 1);
        const int t0 = (lo + i) * wg::TM;
        const uint32_t bytes = (uint32_t)min(wg::TM, Tlen - t0) * Din * 2;
        hopper::mbar_arrive_expect(&full[st], bytes);
        hopper::bulk_load(xs + (size_t)st * wg::TM * ld, xb + (size_t)t0 * Din, bytes, &full[st]);
        if (i == 0) {  // the subject's weights once, behind the first tile
          hopper::mbar_arrive_expect(wbar, W_BYTES);
          hopper::bulk_load(wsm, wimg + (size_t)sidx[b] * W_BYTES, W_BYTES, wbar);
        }
      }
    }
    return;
  }

  // accumulator fragment: warp w holds rows 16w .. 16w + 15; register 4c + e
  // is row lane / 4 (+ 8 for e >= 2), channel 136 grp + 8c + 2 (lane % 4) + e % 2
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * w + lane / 4, cq = 2 * (lane % 4);
  const unsigned char* wh = wsm + grp * (HALF / 8) * 256;  // this warpgroup's 136 channels
  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES, t0 = (lo + i) * wg::TM;
    hopper::mbar_wait(&full[st], (i / STAGES) & 1);
    if (i == 0) hopper::mbar_wait(wbar, 0);
    const bf16* xt = xs + (size_t)st * wg::TM * ld;
    uint32_t a[STEPS][4];
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int k = 16 * j + cq;
      a[j][0] = x_pair(xt, r0, k, Din);
      a[j][1] = x_pair(xt, r0 + 8, k, Din);
      a[j][2] = x_pair(xt, r0, k + 8, Din);
      a[j][3] = x_pair(xt, r0 + 8, k + 8, Din);
    }
    float acc[HALF / 2];
#pragma unroll
    for (int q = 0; q < HALF / 2; ++q) acc[q] = 0.f;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < STEPS; ++j)
      hopper::wgmma_m64n136k16_rs(acc, a[j], hopper::desc_none(wh + (size_t)j * STEP_BYTES, 128, 256));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    // the output tile goes out through the stage that held x: both
    // warpgroups have read x into registers (bar 1), write their channels
    // as bf16 pairs (row stride Dout), and one thread sends the rows, one
    // contiguous run, with a single bulk copy (bar 2 orders the writes
    // before it); the stage goes back to the producer once that copy has
    // read it
    asm volatile("bar.sync 1, 256;" ::: "memory");
    bf16* ot = xs + (size_t)st * wg::TM * ld;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
#pragma unroll
      for (int c = 0; c < HALF / 8; ++c) {
        const int col = grp * HALF + 8 * c + cq;  // even, so col < Dout (even) holds col + 1 too
        if (col < Dout)
          *reinterpret_cast<__nv_bfloat162*>(ot + (size_t)r * Dout + col) =
              __floats2bfloat162_rn(acc[4 * c + 2 * half], acc[4 * c + 2 * half + 1]);
      }
    }
    hopper::fence_proxy_async();
    asm volatile("bar.sync 2, 256;" ::: "memory");
    if (threadIdx.x == 0) {
      const int rows = min(wg::TM, Tlen - t0);
      hopper::bulk_store(out + ((size_t)b * Tlen + t0) * Dout, ot, (uint32_t)rows * Dout * 2);
      hopper::bulk_wait<true>();
      hopper::mbar_arrive(&empty[st]);
    }
  }
  if (threadIdx.x == 0) hopper::bulk_wait<false>();
}

// one 16-byte row (8 reduction indices) of a core matrix of the image a thread
__global__ void subject_matmul_pack_kernel(const bf16* __restrict__ w, uint4* __restrict__ img, int S, int K, int N,
                                           int transposed) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)S * wg::STEPS * wg::GROUPS * 16) return;
  const int r = idx % 8, h = idx / 8 % 2, g = idx / 16 % wg::GROUPS;
  const int j = idx / (16 * wg::GROUPS) % wg::STEPS, s = idx / (16 * wg::GROUPS * wg::STEPS);
  const int nn = 8 * g + r, k0 = 16 * j + 8 * h;
  const bf16* ws = w + (size_t)s * K * N;
  __align__(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int k = k0 + e;
    v[e] = (k < K && nn < N) ? ws[transposed ? (size_t)nn * K + k : (size_t)k * N + nn] : __float2bfloat16(0.f);
  }
  img[idx] = *reinterpret_cast<const uint4*>(v);
}

int launch_wg(const void* x, const void* wimg, const void* sidx, void* out, int B, int Tlen, int Din, int Dout,
              int sms, void* stream) {
  if (Din < 1 || Din > wg::MAX_DIN || Din % 2 || Dout < 1 || Dout > wg::NP || Dout % 2 ||
      ((long long)Tlen * Din) % 8 || ((long long)Tlen * Dout) % 8 || (uintptr_t)x % 16 || (uintptr_t)out % 16 ||
      (uintptr_t)wimg % 16 || sms < 1)
    return (int)cudaErrorInvalidValue;
  static bool attr = false;  // the most any shape needs, set once
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(subject_matmul_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)wg::MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int tiles = (Tlen + wg::TM - 1) / wg::TM;
  // as many runs a recording as one wave holds (at least one), whole tiles each
  int chunks = sms / B < 1 ? 1 : sms / B;
  if (chunks > tiles) chunks = tiles;
  const int per = (tiles + chunks - 1) / chunks;
  chunks = (tiles + per - 1) / per;
  const long long grid = (long long)B * chunks;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)wg::W_BYTES + (size_t)wg::STAGES * wg::TM * (Din > Dout ? Din : Dout) * 2 +
                      (2 * wg::STAGES + 1) * sizeof(uint64_t);
  subject_matmul_wg_kernel<<<(int)grid, wg::THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const unsigned char*)wimg, (const int32_t*)sidx, (bf16*)out, Tlen, Din, Dout, tiles, per,
      chunks);
  return (int)cudaGetLastError();
}

int launch_pack(const void* w, void* img, int S, int K, int N, int transposed, void* stream) {
  if (K < 1 || K > wg::MAX_DIN || N < 1 || N > wg::NP || (uintptr_t)img % 16) return (int)cudaErrorInvalidValue;
  const long long n = (long long)S * wg::STEPS * wg::GROUPS * 16;
  subject_matmul_pack_kernel<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)w, (uint4*)img, S, K, N, transposed);
  return (int)cudaGetLastError();
}

}  // namespace

// Each product entry takes sidx (B,) int32 on the card and, unless it is
// null, sidx_host: pinned host ids copied into sidx on the same stream just
// before the kernel.
static int copy_ids(void* sidx, const void* sidx_host, int B, void* stream) {
  if (sidx_host == nullptr) return (int)cudaSuccess;
  return (int)cudaMemcpyAsync(sidx, sidx_host, (size_t)B * sizeof(int32_t), cudaMemcpyHostToDevice,
                              (cudaStream_t)stream);
}

extern "C" int subject_matmul_f32(const void* x, const void* w, void* sidx, const void* sidx_host, void* out, int B,
                                  int Tlen, int Din, int Dout, void* stream) {
  const int err = copy_ids(sidx, sidx_host, B, stream);
  return err ? err : launch_f32(x, w, sidx, out, B, Tlen, Din, Dout, stream);
}

extern "C" int subject_matmul_bf16(const void* x, const void* w, void* sidx, const void* sidx_host, void* out, int B,
                                   int Tlen, int Din, int Dout, void* stream) {
  const int err = copy_ids(sidx, sidx_host, B, stream);
  return err ? err : launch_tc(x, w, sidx, out, B, Tlen, Din, Dout, stream);
}

// x (B, T, Din) bf16 read where it lies (base 16-byte aligned, T * Din % 8
// == 0 and T * Dout % 8 == 0, Din and Dout even, Din <= 272, Dout <= 272);
// wimg the image subject_matmul_pack_bf16 wrote; out (B, T, Dout) bf16,
// 16-byte aligned; sms: the card's SM count
extern "C" int subject_matmul_wg_bf16(const void* x, const void* wimg, void* sidx, const void* sidx_host, void* out,
                                      int B, int Tlen, int Din, int Dout, int sms, void* stream) {
  const int err = copy_ids(sidx, sidx_host, B, stream);
  return err ? err : launch_wg(x, wimg, sidx, out, B, Tlen, Din, Dout, sms, stream);
}

// the weight image of a product with reduction depth K and N output
// channels (both <= 272): img (S, 17, 34, 2, 8, 8) bf16 from w (S, K, N),
// or with transposed != 0 from w (S, N, K) (the dX's Wᵀ read in place)
extern "C" int subject_matmul_pack_bf16(const void* w, void* img, int S, int K, int N, int transposed,
                                        void* stream) {
  return launch_pack(w, img, S, K, N, transposed, stream);
}
