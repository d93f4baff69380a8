// Retrieval ranks without the B x B similarity matrix:
//   rank[i] = #{ j != i, j < B : dot(y_i, z_j) / max(ny_i * nz_j, eps) > diag_i }.
//
// Replaces the Pallas TPU kernel speech_decoding_tpu/ops/pallas/retrieval.py
// (_ranks_kernel through retrieval_ranks_pallas). There a grid axis walks the
// depth D and a VMEM scratch carries the (bm, bn) partial dots. Here a block
// owns an (i, j) tile of the similarity matrix and walks the depth itself (or
// one slice of it); at the end it normalizes by ny_i * nz_j (clamped to eps),
// leaves out j = i and rows and columns past B, and adds its per-row counts
// of sim > diag_i into ranks[i] with integer atomicAdd (exact, so the order
// of the blocks does not matter). Only the (B,) int32 ranks leave the card's
// scratch; the B x B matrix is never formed.
//
// Two bodies (ops/retrieval.py::_fast_path picks one):
//
// * bf16 z, f32 or bf16 y, D % 8 == 0, 16-byte aligned bases ("wgmma"):
//   bf16 tensor-core products on Hopper (hopper.cuh). y is written as P bf16
//   pieces, y = y1 + y2 + y3 with y1 = bf16(y), y2 = bf16(y - y1), y3 =
//   bf16(y - y1 - y2) (P = 3 for f32 y; P = 1, y itself, for bf16 y). Each
//   subtraction is exact in f32, and a normal f32 number has 24 significant
//   bits, which three round-to-nearest bf16 pieces (8 each, the sign of
//   each remainder giving one more) hold exactly: the pieces add back to y
//   (below about 1e-30, where y2 and y3 become bf16 subnormals, low bits
//   go; that is outside the range of embeddings). A bf16 z is exact in
//   bf16, each product y_p * z of two bf16 numbers is exact in f32, and the
//   three products of a 64-deep chunk go into one fresh f32 accumulator of
//   the tensor cores, which is then added to a running f32 sum on the CUDA
//   cores. The tensor cores' accumulation does not round to nearest, and a
//   368,640-deep sum kept in it moved ranks outside the near-tie band; a
//   64-deep one keeps that error far below the sum's own rounding. So the
//   result is the f32 dot product up to the order of its sums, as the
//   CUDA-core body gives it, and ranks may differ from the plain version
//   only on rows with a near-tie.
//     - retrieval_prep reads y and z once: it writes the pieces into a
//       (P, B, D) bf16 scratch (none for bf16 y) and per-(row, depth slice)
//       partial sums of y^2, z^2 and y.z; a second small kernel adds the
//       slices in a fixed order into ny, nz and diag, so they repeat bit for
//       bit.
//     - retrieval_ranks_wgmma: a 64 (i) x 256 (j) tile a block, K-major
//       operands loaded by TMA with 128-byte swizzling (rows past B and depth
//       past D arrive as zero), a full/empty mbarrier ring of 64-deep stages
//       (the P piece tiles of 64 rows and one z tile of 256) fed by one
//       producer thread, two consumer warpgroups of 128 columns each running
//       wgmma m64n128k16 for every piece on the shared piece tiles. A 64-row
//       tile keeps the three pieces' share of each stage small (24 of 56
//       KB), and 64 + 64 accumulator and sum registers a thread fit beside
//       the addressing (a 128 x 256 tile would need 256).
//     - Split depth: with fewer tiles than SMs (the Trainer's eval has
//       B = 64: one tile) the depth is cut into `splits` slices, one block
//       each, so splits x tiles <= SMs. Each block writes its f32 partial
//       tile (64 KB) to a workspace of at most SMs x 64 KB (8.7 MB on 132
//       SMs); a second pass adds the slices in a fixed order and counts.
//   What bounds it on an H100: operations. At B = 2048 and D = F * T =
//   368,640 the three products are 3 * 2 * B^2 * D = 9.27e12 FLOP, 9.4 ms at
//   the 989 TFLOP/s bf16 peak (the f32 CUDA-core body's bound is 46.2 ms at
//   67 TFLOP/s), against 4.5 GB of y and z (1.35 ms at 3.35 TB/s); the
//   preparation moves 9 GB (2.7 ms). At B = 64 bytes bound it: 141 MB of y
//   and z, 0.04 ms. The pieces scratch is P * B * D bf16 (4.5 GB at B =
//   2048); the wrapper drops it when the call returns.
//
// * everything else ("f32", the first port's body): f32 on the CUDA cores
//   (TF32 keeps about three digits and would reorder near-ties), on f32 rows
//   with norms and diagonal computed outside. A register-blocked SGEMM: 128 x
//   128 tiles over the whole depth, 256 threads, 8 x 8 outputs each, depth
//   chunks of 16 staged transposed in a two-stage shared-memory ring (16-byte
//   loads where D % 4 == 0).
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaGetLastError() of the launches. ranks must be zeroed by the caller.

#include "hopper.cuh"

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BT = 128;  // rows (i) and columns (j) per block
constexpr int BK = 16;   // depth per chunk
constexpr int PAD = 4;
constexpr int SLOTS = BT * BK / 4 / THREADS;  // 4-float pieces of a chunk per thread

// a thread's share of BT rows x BK depth of src (rows r0.., row stride D),
// in registers: piece q = threadIdx.x + THREADS * s is row q / 4, depth
// 4 * (q % 4) .. + 3. Rows past n and depth past D are zero.
template <bool VEC>
__device__ __forceinline__ void fetch(float4 (&v)[SLOTS], const float* __restrict__ src, int r0, int n,
                                      long long D, long long k0) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int q = threadIdx.x + THREADS * s, r = q >> 2, kq = (q & 3) * 4;
    const float* row = src + (size_t)(r0 + r) * D;
    if (r0 + r >= n) {
      v[s] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else if (VEC && k0 + BK <= D) {
      v[s] = *reinterpret_cast<const float4*>(row + k0 + kq);
    } else {
      const long long k = k0 + kq;
      v[s] = make_float4(k < D ? row[k] : 0.f, k + 1 < D ? row[k + 1] : 0.f,
                         k + 2 < D ? row[k + 2] : 0.f, k + 3 < D ? row[k + 3] : 0.f);
    }
  }
}

// the fetched pieces into dst[k][r] (transposed: depth-major)
__device__ __forceinline__ void stash(float (*dst)[BT + PAD], const float4 (&v)[SLOTS]) {
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int q = threadIdx.x + THREADS * s, r = q >> 2, kq = (q & 3) * 4;
    dst[kq + 0][r] = v[s].x;
    dst[kq + 1][r] = v[s].y;
    dst[kq + 2][r] = v[s].z;
    dst[kq + 3][r] = v[s].w;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
retrieval_ranks_kernel(const float* __restrict__ y, const float* __restrict__ z, const float* __restrict__ ny,
                       const float* __restrict__ nz, const float* __restrict__ diag, int32_t* __restrict__ ranks,
                       int B, long long D, float eps) {
  __shared__ __align__(16) float ys[2][BK][BT + PAD];
  __shared__ __align__(16) float zs[2][BK][BT + PAD];
  const int i0 = blockIdx.y * BT, j0 = blockIdx.x * BT;
  const int ty = threadIdx.x / 16;  // rows i0 + ty + 16*q
  const int tx = threadIdx.x % 16;  // cols j0 + tx + 16*c

  float acc[8][8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[q][c] = 0.f;

  float4 yv[SLOTS], zv[SLOTS];
  fetch<VEC>(yv, y, i0, B, D, 0);
  fetch<VEC>(zv, z, j0, B, D, 0);
  stash(ys[0], yv);
  stash(zs[0], zv);
  __syncthreads();
  int cur = 0;
  for (long long k0 = 0; k0 < D; k0 += BK) {
    const bool more = k0 + BK < D;
    if (more) {  // in flight while this chunk is multiplied
      fetch<VEC>(yv, y, i0, B, D, k0 + BK);
      fetch<VEC>(zv, z, j0, B, D, k0 + BK);
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) a[q] = ys[cur][kk][ty + 16 * q];
#pragma unroll
      for (int c = 0; c < 8; ++c) b[c] = zs[cur][kk][tx + 16 * c];
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[q][c] = fmaf(a[q], b[c], acc[q][c]);
    }
    if (more) {
      // the other stage was last read before the previous barrier
      stash(ys[cur ^ 1], yv);
      stash(zs[cur ^ 1], zv);
    }
    __syncthreads();
    cur ^= 1;
  }

#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int i = i0 + ty + 16 * q;
    int cnt = 0;
    if (i < B) {
      const float nyi = ny[i], di = diag[i];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = j0 + tx + 16 * c;
        if (j < B && j != i) cnt += (acc[q][c] / fmaxf(nyi * nz[j], eps)) > di;
      }
    }
    // the 16 threads of a half-warp share row i: sum their counts
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, off, 16);
    if (tx == 0 && cnt > 0) atomicAdd(ranks + i, cnt);
  }
}

// ---- the bf16 body: preparation ------------------------------------------------

namespace k3 {
using hopper::bf16;

constexpr int PREP_THREADS = 256;
constexpr long long PREP_SLICE = 8192;  // depth a preparation block: 4 steps of 8 x 256

// block (i, s): row i, depth [s * PREP_SLICE, ...) of y (f32 or bf16) and z
// (bf16): for f32 y, its three bf16 pieces into pieces[p][i][k]; the slice's
// sums of y^2, z^2 and y.z (f32, each thread's in order, then a fixed tree)
// into part[i][s][0..2]. D % 8 == 0 and 16-byte aligned rows: whole vectors.
template <bool F32>
__global__ void __launch_bounds__(PREP_THREADS)
prep_kernel(const void* __restrict__ yv, const bf16* __restrict__ z, bf16* __restrict__ pieces,
            float* __restrict__ part, int B, long long D, int nsl) {
  const int i = blockIdx.x, s = blockIdx.y;
  const long long k0 = s * PREP_SLICE, k1 = k0 + PREP_SLICE < D ? k0 + PREP_SLICE : D;
  const size_t row = (size_t)i * D;
  float syy = 0.f, szz = 0.f, syz = 0.f;
  for (long long k = k0 + 8 * threadIdx.x; k < k1; k += 8 * PREP_THREADS) {
    const uint4 zq = *reinterpret_cast<const uint4*>(z + row + k);
    const bf16* zb = reinterpret_cast<const bf16*>(&zq);
    float y[8];
    if (F32) {
      const float4 a = *reinterpret_cast<const float4*>((const float*)yv + row + k);
      const float4 b = *reinterpret_cast<const float4*>((const float*)yv + row + k + 4);
      y[0] = a.x, y[1] = a.y, y[2] = a.z, y[3] = a.w, y[4] = b.x, y[5] = b.y, y[6] = b.z, y[7] = b.w;
    } else {
      const uint4 yq = *reinterpret_cast<const uint4*>((const bf16*)yv + row + k);
      const bf16* yb = reinterpret_cast<const bf16*>(&yq);
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = __bfloat162float(yb[e]);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float zf = __bfloat162float(zb[e]);
      syy = fmaf(y[e], y[e], syy);
      szz = fmaf(zf, zf, szz);
      syz = fmaf(y[e], zf, syz);
    }
    if (F32) {
      uint4 q[3];
      bf16* qb[3] = {reinterpret_cast<bf16*>(&q[0]), reinterpret_cast<bf16*>(&q[1]), reinterpret_cast<bf16*>(&q[2])};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const bf16 p1 = __float2bfloat16_rn(y[e]);
        const float r1 = y[e] - __bfloat162float(p1);  // exact
        const bf16 p2 = __float2bfloat16_rn(r1);
        const float r2 = r1 - __bfloat162float(p2);  // exact
        qb[0][e] = p1, qb[1][e] = p2, qb[2][e] = __float2bfloat16_rn(r2);
      }
      const size_t plane = (size_t)B * D;
#pragma unroll
      for (int p = 0; p < 3; ++p) *reinterpret_cast<uint4*>(pieces + p * plane + row + k) = q[p];
    }
  }
  // a fixed tree: within each warp, then the warps in order
  __shared__ float red[PREP_THREADS / 32][3];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    syy += __shfl_down_sync(0xffffffffu, syy, off);
    szz += __shfl_down_sync(0xffffffffu, szz, off);
    syz += __shfl_down_sync(0xffffffffu, syz, off);
  }
  if (threadIdx.x % 32 == 0) {
    red[threadIdx.x / 32][0] = syy, red[threadIdx.x / 32][1] = szz, red[threadIdx.x / 32][2] = syz;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    float t = 0.f;
    for (int w = 0; w < PREP_THREADS / 32; ++w) t += red[w][threadIdx.x];
    part[((size_t)i * nsl + s) * 3 + threadIdx.x] = t;
  }
}

// ny, nz and diag of each row from its slices' sums, added in order
__global__ void norms_kernel(const float* __restrict__ part, float* __restrict__ ny, float* __restrict__ nz,
                             float* __restrict__ diag, int B, int nsl, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float syy = 0.f, szz = 0.f, syz = 0.f;
  for (int s = 0; s < nsl; ++s) {
    const float* q = part + ((size_t)i * nsl + s) * 3;
    syy += q[0], szz += q[1], syz += q[2];
  }
  const float a = sqrtf(syy), b = sqrtf(szz);
  ny[i] = a, nz[i] = b, diag[i] = syz / fmaxf(a * b, eps);
}

// ---- the bf16 body: the products -------------------------------------------------

constexpr int TM = 64;          // rows i a tile (wgmma m)
constexpr int TN = 256;         // columns j a tile: two consumer warpgroups of 128 (wgmma n)
constexpr int WN = 128;         // columns j a consumer warpgroup
constexpr int BK = 64;          // depth a stage: 128 bytes of bf16, one swizzle row
constexpr int ABOX = TM * 128;  // one piece's tile: 8 KB
constexpr int BBOX = TN * 128;  // z's tile: 32 KB
constexpr int CONSUMERS = TN / WN;
constexpr int THREADS = CONSUMERS * 128 + 32;  // the consumer warpgroups, then one producer warp
constexpr int REGS = WN / 2;                    // accumulator registers a thread

template <int P>
struct Ring {
  static constexpr int STAGES = P == 1 ? 5 : 4;  // 5 x 40 KB or 4 x 56 KB (4 measured faster than 3)
  static constexpr int STAGE = P * ABOX + BBOX;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t) + 1024;
};

// Count, for the accumulator fragment of groups c0 .. c0 + NC - 1 (8 columns
// each) of a warpgroup's 64 x 128 tile whose first column is j0, the entries
// of each row that beat its diagonal, and add them to ranks. Fragment: warp
// w holds rows 16w .. 16w + 15; register 4c + e is row lane / 4 (+ 8 for
// e >= 2), column 8c + 2 (lane % 4) + e % 2. i_lo is this lane's first row.
// Every lane of the warp must call it (the four lanes of a row add their
// counts by shuffles).
template <int NC>
__device__ __forceinline__ void count_rows(const float (&v)[4 * NC], int c0, int i_lo, int j0,
                                           const float* __restrict__ ny, const float* __restrict__ nz,
                                           const float* __restrict__ diag, int32_t* __restrict__ ranks, int B,
                                           float eps) {
  const int lane = threadIdx.x % 32;
  int cnt[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i_lo + 8 * h;
    if (i < B) {
      const float nyi = ny[i], di = diag[i];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * (c0 + c) + 2 * (lane % 4) + e;
          if (j < B && j != i) cnt[h] += (v[4 * c + 2 * h + e] / fmaxf(nyi * nz[j], eps)) > di;
        }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    cnt[h] += __shfl_xor_sync(0xffffffffu, cnt[h], 1);
    cnt[h] += __shfl_xor_sync(0xffffffffu, cnt[h], 2);
    if (lane % 4 == 0 && i_lo + 8 * h < B && cnt[h] > 0) atomicAdd(ranks + i_lo + 8 * h, cnt[h]);
  }
}

// Block b takes tile b % tiles (i tile b % tiles / tj, j tile b % tiles %
// tj) and depth slice b / tiles: 64-deep chunks [slice * per, ...) of
// `chunks`. Consumer warpgroup g multiplies the tile's 64 rows of every
// piece by z's columns 128g .. 128g + 127. The tensor cores' f32
// accumulation does not round to nearest, and over a deep sum its error
// grows with the accumulator: so each chunk's products go into a fresh
// accumulator, which is then added to the running f32 sum on the CUDA
// cores (round to nearest). One slice: the block counts its tile. More: it
// writes its f32 partial tile to ws[b] (register r of consumer thread t at
// r * 256 + t; column groups past B are left unwritten) for
// split_sum_kernel.
template <int P>
__global__ void __launch_bounds__(THREADS, 1)
ranks_wgmma_kernel(const __grid_constant__ CUtensorMap ymap, const __grid_constant__ CUtensorMap zmap,
                   const float* __restrict__ ny, const float* __restrict__ nz, const float* __restrict__ diag,
                   int32_t* __restrict__ ranks, float* __restrict__ ws, int B, int chunks, int per, int tj,
                   int tiles, int splits, float eps) {
  using R = Ring<P>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)R::STAGES * R::STAGE);
  uint64_t* empty = full + R::STAGES;
  const int tile = blockIdx.x % tiles, slice = blockIdx.x / tiles;
  const int i0 = tile / tj * TM, j0 = tile % tj * TN;
  const int c_lo = slice * per, c_hi = c_lo + per < chunks ? c_lo + per : chunks;
  const int n = c_hi > c_lo ? c_hi - c_lo : 0;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // producer warp: one thread issues every load
    if (threadIdx.x == CONSUMERS * 128) {
      for (int k = 0; k < n; ++k) {
        const int st = k % R::STAGES, d0 = (c_lo + k) * BK;
        if (k >= R::STAGES) hopper::mbar_wait(&empty[st], (k / R::STAGES - 1) & 1);
        unsigned char* stage = smem + (size_t)st * R::STAGE;
        hopper::mbar_arrive_expect(&full[st], R::STAGE);
#pragma unroll
        for (int p = 0; p < P; ++p) hopper::tma_load_3d(stage + p * ABOX, &ymap, &full[st], d0, i0, p);
        hopper::tma_load_3d(stage + P * ABOX, &zmap, &full[st], d0, j0, 0);
      }
    }
    return;
  }

  // a warpgroup whose 128 columns all lie past B multiplies nothing
  const int jw = j0 + WN * wg;
  const bool live = jw < B;
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  float acc[REGS], sum[REGS];
#pragma unroll
  for (int r = 0; r < REGS; ++r) sum[r] = 0.f;
  for (int k = 0; k < n; ++k) {
    const int st = k % R::STAGES;
    hopper::mbar_wait(&full[st], (k / R::STAGES) & 1);
    if (live) {
      const unsigned char* a_t = smem + (size_t)st * R::STAGE;                         // the 64 rows of y
      const unsigned char* b_t = smem + (size_t)st * R::STAGE + P * ABOX + wg * WN * 128;  // this warpgroup's z rows
#pragma unroll
      for (int r = 0; r < REGS; ++r) acc[r] = 0.f;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // both K-major: the next 16 of the depth start 32 bytes along each 128-byte row
        const uint64_t db = hopper::desc_sw128(b_t + kk * 32, 16, 1024);
#pragma unroll
        for (int p = 0; p < P; ++p)
          hopper::wgmma_m64n128k16<0, 0>(acc, hopper::desc_sw128(a_t + p * ABOX + kk * 32, 16, 1024), db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
    }
    if (lane == 0) hopper::mbar_arrive(&empty[st]);  // the stage goes back before the sums
    if (live) {
#pragma unroll
      for (int r = 0; r < REGS; ++r) sum[r] += acc[r];
    }
  }

  const int i_lo = i0 + 16 * w + lane / 4;
  if (splits == 1) {
    count_rows<WN / 8>(sum, 0, i_lo, jw, ny, nz, diag, ranks, B, eps);
  } else if (live) {
    float* out = ws + (size_t)blockIdx.x * TM * TN + threadIdx.x;
#pragma unroll
    for (int r = 0; r < REGS; ++r)
      if (jw + 8 * (r / 4) < B) out[(size_t)r * (CONSUMERS * 128)] = sum[r];
  }
}

// Block (tile, c): column group c (8 columns) of each consumer warpgroup's
// part of a tile; each consumer thread's 4 registers of that group, summed
// over the slices in order, then counted as the one-slice body counts them.
__global__ void __launch_bounds__(CONSUMERS * 128)
split_sum_kernel(const float* __restrict__ ws, const float* __restrict__ ny, const float* __restrict__ nz,
                 const float* __restrict__ diag, int32_t* __restrict__ ranks, int B, int tj, int tiles, int splits,
                 float eps) {
  const int tile = blockIdx.x, c = blockIdx.y;
  const int i0 = tile / tj * TM, j0 = tile % tj * TN;
  if (j0 + 8 * c >= B) return;
  const int wg = threadIdx.x / 128, w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int jw = j0 + WN * wg;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (jw + 8 * c < B) {
    const float* in = ws + (size_t)tile * TM * TN + (size_t)(4 * c) * (CONSUMERS * 128) + threadIdx.x;
    const size_t step = (size_t)tiles * TM * TN;
    int s = 0;
    for (; s + 4 <= splits; s += 4) {  // four slices' loads in flight, added in order
      float t[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[q][e] = in[(s + q) * step + e * (CONSUMERS * 128)];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] += t[q][e];
    }
    for (; s < splits; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] += in[s * step + e * (CONSUMERS * 128)];
  }
  count_rows<1>(v, c, i0 + 16 * w + lane / 4, jw, ny, nz, diag, ranks, B, eps);
}

template <int P>
int launch_products(const void* pieces, const void* z, const void* ny, const void* nz, const void* diag,
                    void* ranks, void* ws, int B, long long D, int splits, float eps, cudaStream_t stream) {
  CUtensorMap ymap, zmap;
  if (D > 0x7fffffffLL || !hopper::make_map_bf16(&ymap, pieces, (int)D, B, P, TM) ||
      !hopper::make_map_bf16(&zmap, z, (int)D, B, 1, TN))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;  // set once a process
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(ranks_wgmma_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Ring<P>::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int chunks = (int)((D + BK - 1) / BK), per = (chunks + splits - 1) / splits;
  const int ti = (B + TM - 1) / TM, tj = (B + TN - 1) / TN, tiles = ti * tj;
  ranks_wgmma_kernel<P><<<tiles * splits, THREADS, Ring<P>::SMEM, stream>>>(
      ymap, zmap, (const float*)ny, (const float*)nz, (const float*)diag, (int32_t*)ranks, (float*)ws, B, chunks,
      per, tj, tiles, splits, eps);
  if (splits > 1)
    split_sum_kernel<<<dim3(tiles, WN / 8), CONSUMERS * 128, 0, stream>>>(
        (const float*)ws, (const float*)ny, (const float*)nz, (const float*)diag, (int32_t*)ranks, B, tj, tiles,
        splits, eps);
  return (int)cudaGetLastError();
}

}  // namespace k3
}  // namespace

extern "C" int retrieval_ranks_f32(const void* y, const void* z, const void* ny, const void* nz,
                                   const void* diag, void* ranks, int B, long long D, float eps, void* stream) {
  const dim3 grid((B + BT - 1) / BT, (B + BT - 1) / BT);
  const bool vec = D % 4 == 0 && (uintptr_t)y % 16 == 0 && (uintptr_t)z % 16 == 0;
  if (vec)
    retrieval_ranks_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)y, (const float*)z, (const float*)ny, (const float*)nz, (const float*)diag,
        (int32_t*)ranks, B, D, eps);
  else
    retrieval_ranks_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)y, (const float*)z, (const float*)ny, (const float*)nz, (const float*)diag,
        (int32_t*)ranks, B, D, eps);
  return (int)cudaGetLastError();
}

// y (B, D) f32 (y_f32 = 1) or bf16, z (B, D) bf16; D % 8 == 0, bases 16-byte
// aligned. pieces (3, B, D) bf16 (f32 y only; unused for bf16 y), part
// (B, nsl, 3) f32 scratch with nsl = ceil(D / 8192); writes ny, nz, diag (B,) f32.
extern "C" int retrieval_prep(const void* y, const void* z, void* pieces, void* part, void* ny, void* nz, void* diag,
                              int B, long long D, int y_f32, int nsl, float eps, void* stream) {
  if (B <= 0 || D <= 0 || D % 8 != 0 || nsl != (int)((D + k3::PREP_SLICE - 1) / k3::PREP_SLICE))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, nsl);
  if (y_f32)
    k3::prep_kernel<true><<<grid, k3::PREP_THREADS, 0, (cudaStream_t)stream>>>(
        y, (const hopper::bf16*)z, (hopper::bf16*)pieces, (float*)part, B, D, nsl);
  else
    k3::prep_kernel<false><<<grid, k3::PREP_THREADS, 0, (cudaStream_t)stream>>>(
        y, (const hopper::bf16*)z, nullptr, (float*)part, B, D, nsl);
  k3::norms_kernel<<<(B + 255) / 256, 256, 0, (cudaStream_t)stream>>>((const float*)part, (float*)ny, (float*)nz,
                                                                      (float*)diag, B, nsl, eps);
  return (int)cudaGetLastError();
}

// pieces (P, B, D) bf16 (P = 3: f32 y's pieces; P = 1: a bf16 y itself), z
// (B, D) bf16, D % 8 == 0, bases 16-byte aligned; ny, nz, diag from
// retrieval_prep; ranks (B,) int32, zeroed; ws: splits x tiles x 64 x 256
// f32 when splits > 1 (tiles = ceil(B / 64) * ceil(B / 256)), else unused.
extern "C" int retrieval_ranks_wgmma(const void* pieces, const void* z, const void* ny, const void* nz,
                                     const void* diag, void* ranks, void* ws, int B, long long D, int P, int splits,
                                     float eps, void* stream) {
  if (B <= 0 || D <= 0 || splits < 1 || (P != 1 && P != 3)) return (int)cudaErrorInvalidValue;
  return P == 3 ? k3::launch_products<3>(pieces, z, ny, nz, diag, ranks, ws, B, D, splits, eps, (cudaStream_t)stream)
                : k3::launch_products<1>(pieces, z, ny, nz, diag, ranks, ws, B, D, splits, eps, (cudaStream_t)stream);
}
