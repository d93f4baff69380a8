// The persistent TMA + mbarrier + wgmma implicit GEMM of the dilated
// three-tap 'SAME' conv, templated on a per-element epilogue functor:
//   acc[b, t, n] = sum_j sum_ci x[b, t + (j - 1) d, ci] * wk[j, n, ci]
// then epi(b, t, channel, value, gate, s0, s1) for every output. It is K5's
// kernel (tap_conv.cu) with the epilogue made a parameter, and two kernels
// instantiate it: K6's six train-mode stages (conv_block_train.cu, each with
// its own epilogue and per-channel sums) and K4's eval ConvBlock
// (conv_block.cu, three convs a block with the folded-BN GELU and GLU
// epilogues). Its per-tile parts (the ring, a tile's loads, its products,
// its epilogue and sums) are device functions, which K7's merged walk of
// F3's and F1's tiles (conv_block_train.cu, f31_wg_kernel) calls as well.
// The tensor map's zero fill gives every recording its 'SAME' padding
// (hopper.cuh).
//
// Replaces the Pallas device primitive _conv3 (speech_decoding_tpu/ops/
// pallas/conv_block.py:50) as the kernels of speech_decoding_tpu/ops/pallas/
// conv_block.py (_block_kernel) and conv_block_train.py (_f1_kernel ..
// _b3_kernel) call it on a VMEM-resident recording: here a persistent block
// walks (192-time, 160-column) output tiles of all recordings, so no
// recording has to fit in shared memory.
//
// An epilogue functor Epi provides
//   static constexpr bool kStats:      its per-channel sums s0, s1 go to `part`;
//   static constexpr bool kUnguarded:  a warp wholly inside the output may run
//                                      it without the per-element guard;
//   __device__ void operator()(int b, int t, int c, float v, float g, float& s0, float& s1) const
// with g the gate of channel c when NG = 2 (the GLU conv, packed columns 2c
// and 2c + 1), unused when NG = 1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#define CHECK(expr)                 \
  do {                              \
    const int e_ = (expr);          \
    if (e_ != 0) return e_;         \
  } while (0)

namespace {

namespace wg {
constexpr int CONSUMERS = 3;          // consumer warpgroups, 64 times each (K5's shape)
constexpr int TM = 64 * CONSUMERS;    // times a tile
constexpr int TN = 160;               // packed output columns a tile (wgmma n)
constexpr int STAGES = 4;
constexpr int ABOX = TM * 128;        // the input: TM rows of 64 channels, 128-byte swizzled
constexpr int BBOX = TN * 128;        // W_j: 160 packed output rows of 64 input channels
constexpr int STAGE = ABOX + BBOX;
constexpr int WARPS = 4 * CONSUMERS;
constexpr int THREADS = CONSUMERS * 128 + 32;  // the consumer warpgroups, then one producer warp
constexpr int RED = WARPS * 2 * TN;   // floats: every consumer warp's two sums of every column
constexpr size_t SMEM =
    (size_t)STAGES * STAGE + 2 * RED * sizeof(float) + 2 * STAGES * sizeof(uint64_t) + STAGES * sizeof(int) + 1024;

inline int t_tiles(int Tlen) { return (Tlen + TM - 1) / TM; }
}  // namespace wg

// a barrier of the consumer warpgroups alone (the producer runs ahead)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(wg::CONSUMERS * 128) : "memory");
}

// The epilogue of one thread's accumulator fragment: every (row, channel)
// it holds through epi (GUARD: only those inside the output), and with
// Epi::kStats the warp's per-channel sums into r[(2 * warp + {0, 1}) * TN +
// channel in the tile]: each thread adds its own two rows, the 8 lanes that
// share a channel add theirs with shuffles in a fixed tree.
template <bool GUARD, int NG, class Epi>
__device__ __forceinline__ void epilogue(const Epi& epi, const float (&acc)[wg::TN / 2], float* r, int warp, int lane,
                                         int b, int t_lo, int ch0, int Tlen, int Cout) {
#pragma unroll
  for (int c = 0; c < wg::TN / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 2 / NG; ++e) {
      const int lc = (8 * c + 2 * (lane % 4) + e) / NG, ch = ch0 + lc;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t_lo + 8 * half;
        if (!GUARD || (t < Tlen && ch < Cout))
          epi(b, t, ch, acc[4 * c + 2 * half + e], acc[4 * c + 2 * half + 1], s0, s1);
      }
      if constexpr (Epi::kStats) {
#pragma unroll
        for (int o = 4; o < 32; o *= 2) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (lane < 4) {
          r[(2 * warp) * wg::TN + lc] = s0;
          r[(2 * warp + 1) * wg::TN + lc] = s1;
        }
      }
    }
  }
}

// The block's share of shared memory: the four-stage ring of (input, W_j)
// tiles, the consumer warps' sums (double-buffered across tiles), the ring's
// full and empty barriers, and one tile index a stage (set by a producer that
// claims its tiles; unused by conv_wg_kernel)
struct Ring {
  unsigned char* stage;
  float* red;
  uint64_t* full;
  uint64_t* empty;
  int* tile;
};

// carve the ring out of dynamic shared memory and initialise its barriers
// (full: the producer's one arrival and the bytes; empty: every consumer
// warp); every thread of the block calls it
__device__ __forceinline__ Ring ring_init(unsigned char* smem_raw) {
  Ring r;
  r.stage = reinterpret_cast<unsigned char*>(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  r.red = reinterpret_cast<float*>(r.stage + (size_t)wg::STAGES * wg::STAGE);
  r.full = reinterpret_cast<uint64_t*>(r.red + 2 * wg::RED);
  r.empty = r.full + wg::STAGES;
  r.tile = reinterpret_cast<int*>(r.empty + wg::STAGES);
  if (threadIdx.x == 0) {
    for (int i = 0; i < wg::STAGES; ++i) {
      hopper::mbar_init(&r.full[i], 1);
      hopper::mbar_init(&r.empty[i], wg::WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();
  return r;
}

// The producer thread's loads of one output tile (co0, t0, b): for each tap
// j and 64-channel chunk c, the input rows t0 + (j - 1) d + [0, TM) and W_j's
// packed rows co0 + [0, TN) into the next stage of the ring; k counts the
// block's loads. With tile >= 0 the tile's index goes with its first stage.
__device__ __forceinline__ void load_tile(const Ring& r, const CUtensorMap* xmap, const CUtensorMap* wmap, int co0,
                                          int t0, int b, int d, int chunks, int& k, int tile = -1) {
  for (int s = 0; s < 3 * chunks; ++s, ++k) {
    const int st = k % wg::STAGES, j = s / chunks, c = s % chunks;
    if (k >= wg::STAGES) hopper::mbar_wait(&r.empty[st], (k / wg::STAGES - 1) & 1);
    unsigned char* stage = r.stage + (size_t)st * wg::STAGE;
    if (tile >= 0 && s == 0) r.tile[st] = tile;
    hopper::mbar_arrive_expect(&r.full[st], wg::STAGE);
    hopper::tma_load_3d(stage, xmap, &r.full[st], 64 * c, t0 + (j - 1) * d, b);
    hopper::tma_load_3d(stage + wg::ABOX, wmap, &r.full[st], 64 * c, co0, j);
  }
}

// A consumer warpgroup's products of one tile: `steps` stages of the ring
// into acc, each released to the producer as soon as its products are done.
// The accumulator fragment: warp w holds rows 16w .. 16w + 15; register
// 4c + e is row lane / 4 (+ 8 for e >= 2), column 8c + 2 (lane % 4) + e % 2
__device__ __forceinline__ void mma_tile(const Ring& r, float (&acc)[wg::TN / 2], int steps, int wg_, int lane,
                                         int& k) {
#pragma unroll
  for (int i = 0; i < wg::TN / 2; ++i) acc[i] = 0.f;
  for (int s = 0; s < steps; ++s, ++k) {
    const int st = k % wg::STAGES;
    hopper::mbar_wait(&r.full[st], (k / wg::STAGES) & 1);
    const unsigned char* a_t = r.stage + (size_t)st * wg::STAGE + wg_ * 64 * 128;  // this warpgroup's 64 rows
    const unsigned char* b_t = r.stage + (size_t)st * wg::STAGE + wg::ABOX;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::desc_sw128(a_t + kk * 32, 16, 1024);
      const uint64_t db = hopper::desc_sw128(b_t + kk * 32, 16, 1024);
      hopper::wgmma_m64n160k16<0, 0>(acc, da, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&r.empty[st]);
  }
}

// A tile's outputs through epi and, with Epi::kStats, the 12 warps' sums
// through r (one of the two buffers of the ring's `red`) added in warp order
// into the tile's slot of `part`
template <int NG, class Epi>
__device__ __forceinline__ void store_tile(const Epi& epi, const float (&acc)[wg::TN / 2], float* r, float* part,
                                           int wg_, int w, int lane, int co0, int tt, int b, int Tlen, int Cout,
                                           int t_tiles) {
  constexpr int COLS = wg::TN / NG;  // output channels a tile
  const int warp = 4 * wg_ + w, ch0 = co0 / NG, t_lo = tt * wg::TM + 64 * wg_ + 16 * w + lane / 4;
  // a warp whose 16 rows and every channel lie inside the output runs a
  // light epilogue without a guard, so its loads can be issued together
  // (the test is warp-uniform: both paths hold full-warp shuffles); the
  // GELU backward's, unguarded, spills and runs slower
  if (Epi::kUnguarded && tt * wg::TM + 64 * wg_ + 16 * w + 15 < Tlen && ch0 + COLS <= Cout)
    epilogue<false, NG>(epi, acc, r, warp, lane, b, t_lo, ch0, Tlen, Cout);
  else
    epilogue<true, NG>(epi, acc, r, warp, lane, b, t_lo, ch0, Tlen, Cout);
  if constexpr (Epi::kStats) {
    consumers_sync();
    for (int i = threadIdx.x; i < 2 * COLS; i += wg::CONSUMERS * 128) {
      const int s = i / COLS, lc = i % COLS;
      if (ch0 + lc < Cout) {
        float v = 0.f;
        for (int q = 0; q < wg::WARPS; ++q) v += r[(2 * q + s) * wg::TN + lc];
        part[((size_t)b * t_tiles + tt) * 2 * Cout + (size_t)s * Cout + ch0 + lc] = v;
      }
    }
  }
}

// The dilated three-tap conv of x (B, T, cin_ld) with the K-major weights wk
// (3, NG * Cout, cin_ld), every output through epi. K5's kernel
// (tap_conv.cu): persistent blocks walk the (co tile, time tile, recording)
// tiles, one producer thread keeps a four-stage ring of TMA loads of (tap j,
// 64-channel chunk), three consumer warpgroups run wgmma m64n160k16 into one
// f32 accumulator. NG = 1: packed column n is channel n. NG = 2 (the GLU
// conv): packed columns 2c and 2c + 1 are channel c's value and gate, so a
// tile of 160 packed columns is 80 channels, and the register pair that
// holds a thread's two adjacent columns holds both halves of one channel.
// Sums (Epi::kStats): each thread adds its own two rows of a column, the 8
// lanes of a warp that share the column add theirs with shuffles in a fixed
// tree, the 12 warps' sums go through shared memory (double-buffered across
// tiles) and are added in warp order into the tile's slot of `part`,
// part[(b * t_tiles + time tile) * 2 * Cout + {0, Cout} + c].
template <int NG, class Epi>
__global__ void __launch_bounds__(wg::THREADS, 1)
conv_wg_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap, const Epi epi,
               float* __restrict__ part, int Tlen, int Cout, int d, int chunks, int co_tiles, int t_tiles,
               int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int wg_ = threadIdx.x / 128;
  if (wg_ == wg::CONSUMERS) {  // producer warp: one thread issues every load
    if (threadIdx.x == wg::CONSUMERS * 128) {
      int k = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int co0 = tile % co_tiles * wg::TN, t0 = tile / co_tiles % t_tiles * wg::TM,
                  b = tile / (co_tiles * t_tiles);
        load_tile(r, &xmap, &wmap, co0, t0, b, d, chunks, k);
      }
    }
    return;
  }

  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  float acc[wg::TN / 2];
  int k = 0, it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    const int co0 = tile % co_tiles * wg::TN, tt = tile / co_tiles % t_tiles, b = tile / (co_tiles * t_tiles);
    mma_tile(r, acc, 3 * chunks, wg_, lane, k);
    store_tile<NG>(epi, acc, r.red + (it & 1) * wg::RED, part, wg_, w, lane, co0, tt, b, Tlen, Cout, t_tiles);
  }
}

// x (B, T, cin_ld) bf16, channels zero-padded to cin_ld (a multiple of 8),
// and wk (3, NG * Cout, cin_ld), both 16-byte aligned; sms: one persistent
// block each
template <int NG, class Epi>
int conv_wg(const void* x, int cin_ld, const void* wk, const Epi& epi, float* part, int B, int Tlen, int Cout, int d,
            int sms, cudaStream_t st) {
  if ((long long)B * Tlen == 0 || Cout == 0) return (int)cudaSuccess;
  CUtensorMap xmap, wmap;
  if (!hopper::make_map_bf16(&xmap, x, cin_ld, Tlen, B, wg::TM) ||
      !hopper::make_map_bf16(&wmap, wk, cin_ld, NG * Cout, 3, wg::TN))
    return (int)cudaErrorInvalidValue;
  auto kernel = conv_wg_kernel<NG, Epi>;
  CHECK((int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wg::SMEM));
  const int co_tiles = (NG * Cout + wg::TN - 1) / wg::TN, t_tiles = wg::t_tiles(Tlen);
  const long long tiles = (long long)co_tiles * t_tiles * B;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, wg::THREADS, wg::SMEM, st>>>(xmap, wmap, epi, part, Tlen, Cout, d, (cin_ld + 63) / 64, co_tiles,
                                              t_tiles, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace
