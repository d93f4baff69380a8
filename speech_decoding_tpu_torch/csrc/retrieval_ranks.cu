// Retrieval ranks without the B x B similarity matrix:
//   rank[i] = #{ j != i, j < B : dot(y_i, z_j) / max(ny_i * nz_j, eps) > diag_i }.
//
// Replaces the Pallas TPU kernel speech_decoding_tpu/ops/pallas/retrieval.py
// (_ranks_kernel through retrieval_ranks_pallas). There a grid axis walks the
// depth D and a VMEM scratch carries the (bm, bn) partial dots. Here each
// block owns a 128 x 128 (i, j) tile of the similarity matrix and loops over
// the whole depth itself; at the end it normalizes by ny_i * nz_j (clamped to
// eps), leaves out j = i and columns past B, and adds its per-row counts of
// sim > diag_i into ranks[i] with integer atomicAdd (exact, so the order of
// the blocks does not matter). The norms and the diagonal are O(B * D) and are
// computed outside, as the JAX wrapper does.
//
// What bounds it on an H100: operations. At B = 2048 and D = F * T = 368,640
// it does 2 * B^2 * D = 3.09e12 FLOP, 46 ms at the 67 TFLOP/s f32 peak of the
// CUDA cores, against 6 GB of input (1.8 ms at 3.35 TB/s). It stays in f32 on
// the CUDA cores: TF32 keeps about three digits and would reorder near-ties.
// The design is a register-blocked SGEMM: 256 threads, 8 x 8 outputs each,
// depth chunks of 16 staged transposed in a two-stage shared-memory ring
// (16-byte loads where D % 4 == 0): the next chunk's loads sit in registers
// while the current chunk is multiplied, and each shared-memory read feeds 8
// FMAs.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaGetLastError() of the launch. ranks must be zeroed by the caller.

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
