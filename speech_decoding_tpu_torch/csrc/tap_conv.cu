// K5: the dilated k=3 'SAME' conv in one launch,
//   y[b, t] = sum_j x[b, t + (j - 1) d] @ W_j,  j = 0, 1, 2,
// rows of x outside [0, T) read as zero, f32 accumulation, one cast to x's
// dtype at the output.
//
// Replaces the Pallas TPU kernel speech_decoding_tpu/ops/pallas/tap_conv.py
// (_tap_conv_kernel through tap_conv). The Pallas kernel keeps two whole
// recordings and the (3, Cin, Cout) weights in VMEM and adds the three tap
// products shifted. The backward's dx is this kernel on the tap-reversed,
// transposed weights, and dW is K2 (tap_conv_dw.cu).
//
// What bounds it on an H100: operations. The flagship's 320 -> 320 conv at
// B = 64, T = 360 is 14.2 GFLOP (14 us at 989 TFLOP/s in bf16) against
// ~30 MB of x, W and y (9 us at 3.35 TB/s).
//   * bf16: an implicit GEMM on Hopper's tensor-core path (hopper.cuh). A
//     tile is 192 times of one recording x 160 output channels (160 divides
//     320 and 640); a tile's K loop is only 15 steps at Cin = 320, so the
//     blocks are persistent (one per SM, each walking tiles), and the
//     producer's loads for the next tile overlap the consumers' stores of
//     the last. The K loop walks (tap j, 64-channel chunk): one producer
//     thread keeps a four-stage ring of TMA loads in flight, per
//     step x's rows t0 + (j - 1) d .. + 191 (K-major A; rows outside the
//     recording arrive as zero, which is the 'SAME' padding) and the chunk of
//     W_j packed K-major by the wrapper (w transposed to (3, Cout, Cin),
//     channels zero-padded to a multiple of 8). Three consumer warpgroups run
//     wgmma m64n160k16 on 64 rows each, all three taps into one f32
//     accumulator, and round once to bf16 as they store; rows t >= T and
//     channels >= Cout are masked. TMA needs 16-byte row strides, so a
//     270-channel x (or one with a misaligned base) reaches the kernel as a
//     zero-padded 272-channel copy made by the wrapper; the packed weights
//     are padded in the same copy that packs them, so every weight row moves
//     as whole 16-byte pieces.
//   * f32: the conv tile of tap3.cuh (time tiles with a halo of d, weights
//     streamed through shared memory in 32-channel chunks), shared with K6,
//     on the CUDA cores: the tests' and the card-vs-CPU check's path.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaGetLastError() of the launch (or of the shared-memory attribute call).

#include "hopper.cuh"
#include "tap3.cuh"

namespace {

template <typename T>
struct Store {
  static constexpr bool kStats = false;
  T* y;
  int T_, C;
  __device__ void operator()(int b, int t, int c, float v, float, float&, float&) const {
    y[((size_t)b * T_ + t) * C + c] = tap3::from_f<T>(v);
  }
};

namespace k5 {
constexpr int CONSUMERS = 3;          // consumer warpgroups, 64 times each (3 measured 5-10% faster than 2)
constexpr int TM = 64 * CONSUMERS;    // times a tile
constexpr int TN = 160;               // output channels a block (wgmma n)
constexpr int STAGES = 4;
constexpr int ABOX = TM * 128;        // x: TM rows of 64 channels, 128-byte swizzled
constexpr int BBOX = TN * 128;        // W_j: 160 output rows of 64 input channels: 20 KB
constexpr int STAGE = ABOX + BBOX;
constexpr int THREADS = CONSUMERS * 128 + 32;  // the consumer warpgroups, then one producer warp
constexpr size_t SMEM = (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t) + 1024;
}  // namespace k5

// A persistent block: block i takes tiles i, i + gridDim.x, ... of the
// (co tile, time tile, recording) grid, co tiles fastest, so the blocks in
// flight share the rows of x in L2. The producer runs ahead into the next
// tile's loads while the consumers store the last one. Steps k = j * chunks
// + c of a tile: tap j, input channels 64c .. 64c + 63; the ring's stage and
// phase follow a step count kept across tiles. Empty barriers take one
// arrival per consumer warp.
__global__ void __launch_bounds__(k5::THREADS, 1)
tap_conv_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                     hopper::bf16* __restrict__ y, int Tlen, int Cout, int d, int chunks, int co_tiles,
                     int t_tiles, int tiles) {
  using namespace k5;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int steps = 3 * chunks;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 4 * CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {  // producer warp: one thread issues every load
    if (threadIdx.x == CONSUMERS * 128) {
      int k = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int co0 = tile % co_tiles * TN, t0 = tile / co_tiles % t_tiles * TM, b = tile / (co_tiles * t_tiles);
        for (int s = 0; s < steps; ++s, ++k) {
          const int st = k % STAGES, j = s / chunks, c = s % chunks;
          if (k >= STAGES) hopper::mbar_wait(&empty[st], (k / STAGES - 1) & 1);
          unsigned char* stage = smem + (size_t)st * STAGE;
          hopper::mbar_arrive_expect(&full[st], STAGE);
          hopper::tma_load_3d(stage, &xmap, &full[st], 64 * c, t0 + (j - 1) * d, b);
          hopper::tma_load_3d(stage + ABOX, &wmap, &full[st], 64 * c, co0, j);
        }
      }
    }
    return;
  }

  // accumulator fragment: warp w holds rows 16w .. 16w + 15; register 4c + e
  // is row lane / 4 (+ 8 for e >= 2), column 8c + 2 (lane % 4) + e % 2
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const bool pairs = Cout % 2 == 0;  // 4-byte aligned column pairs
  float acc[TN / 2];
  int k = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int co0 = tile % co_tiles * TN, t0 = tile / co_tiles % t_tiles * TM, b = tile / (co_tiles * t_tiles);
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < steps; ++s, ++k) {
      const int st = k % STAGES;
      hopper::mbar_wait(&full[st], (k / STAGES) & 1);
      const unsigned char* a_t = smem + (size_t)st * STAGE + wg * 64 * 128;  // this warpgroup's 64 rows
      const unsigned char* b_t = smem + (size_t)st * STAGE + ABOX;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // both K-major: the next 16 channels start 32 bytes along each 128-byte row
        const uint64_t da = hopper::desc_sw128(a_t + kk * 32, 16, 1024);
        const uint64_t db = hopper::desc_sw128(b_t + kk * 32, 16, 1024);
        hopper::wgmma_m64n160k16<0, 0>(acc, da, db);
      }
      hopper::wgmma_commit();
      // the stage goes back to the producer as soon as its products are done
      // (keeping one step in flight and releasing a step later measured
      // slower: it takes a stage out of the ring)
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }

    const int t_lo = t0 + 64 * wg + 16 * w + lane / 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t_lo + 8 * half;
      if (t >= Tlen) continue;
      hopper::bf16* row = y + ((size_t)b * Tlen + t) * Cout;
#pragma unroll
      for (int c = 0; c < TN / 8; ++c) {
        const int col = co0 + 8 * c + 2 * (lane % 4);
        const float v0 = acc[4 * c + 2 * half], v1 = acc[4 * c + 2 * half + 1];
        if (pairs && col + 1 < Cout) {
          *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (col < Cout) row[col] = __float2bfloat16(v0);
          if (col + 1 < Cout) row[col + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

}  // namespace

// x (B, T, Cin), w (3, Cin, Cout), y (B, T, Cout) f32; 0 < d
extern "C" int tap_conv_f32(const void* x, const void* w, void* y, int B, int Tlen, int Cin, int Cout, int d,
                            void* stream) {
  const tap3::Conv g = tap3::make_conv(B, Tlen, Cin, Cout, Cout, 0, d, x, w);
  return tap3::launch_conv<float, 1>(x, w, g, tap3::Ident{}, Store<float>{(float*)y, Tlen, Cout}, nullptr,
                                     (cudaStream_t)stream);
}

// x (B, T, cin_ld) bf16 with its channels zero-padded to cin_ld (a multiple
// of 8), wk (3, Cout, cin_ld) the K-major weights (wk[j, co, ci] = W_j[ci,
// co], zero past Cin), y (B, T, Cout) bf16; bases 16-byte aligned; 0 < d;
// sms: the card's SM count (one persistent block each)
extern "C" int tap_conv_bf16(const void* x, const void* wk, void* y, int B, int Tlen, int cin_ld, int Cout, int d,
                             int sms, void* stream) {
  CUtensorMap xmap, wmap;
  if (!hopper::make_map_bf16(&xmap, x, cin_ld, Tlen, B, k5::TM) ||
      !hopper::make_map_bf16(&wmap, wk, cin_ld, Cout, 3, k5::TN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(tap_conv_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k5::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int co_tiles = (Cout + k5::TN - 1) / k5::TN, t_tiles = (Tlen + k5::TM - 1) / k5::TM;
  const long long tiles = (long long)co_tiles * t_tiles * B;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (tiles == 0) return (int)cudaSuccess;
  const int grid = (int)(tiles < sms ? tiles : sms);
  tap_conv_bf16_kernel<<<grid, k5::THREADS, k5::SMEM, (cudaStream_t)stream>>>(
      xmap, wmap, (hopper::bf16*)y, Tlen, Cout, d, (cin_ld + 63) / 64, co_tiles, t_tiles, (int)tiles);
  return (int)cudaGetLastError();
}
