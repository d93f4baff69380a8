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
// read once, dW written once: ~0.03 ms). So the bf16 design is built around
// Hopper's tensor-core path (hopper.cuh):
//   * bf16: a block owns a 64 (ci) x 128 (co) tile of all three taps over a
//     split of the recordings. One producer thread keeps a four-stage ring
//     of TMA loads in flight: per 64-row time chunk, g's 128 channels once and
//     x's 64 channels once per tap, at time t0 + (j - 1) d (a tap cannot be a
//     descriptor offset into one window: with 128-byte swizzling it would have
//     to be a multiple of 8 rows). Three consumer warpgroups, one per tap,
//     each run wgmma m64n128k16 on X_jᵀ G with both operands MN-major (the
//     channels of x and g are contiguous) into their own f32 accumulator, and
//     release the stage through an mbarrier. Rows outside [0, T) arrive as
//     zero from the 3-D tensor maps, so rows past T contribute nothing and,
//     when d >= T, the shifted taps come out zero. TMA needs 16-byte row
//     strides: the wrapper passes x and g with their channels zero-padded to
//     a multiple of 8 (a copy only where Cin = 270 or a base is misaligned).
//     Splits: about one block per SM over the grid; the partials (nsplit x 3 x
//     round64(Cin) x round128(Cout) f32, 11.8 MB at 320 -> 320 with 8 splits
//     against 19.7 MB with the earlier 64 x 64 tiles) are added in a fixed order.
//   * f32: 32-row chunks staged synchronously, 4 x 4 outputs x 3 taps a
//     thread on the CUDA cores (the tests' and the card-vs-CPU check's path);
//     channels past Cin/Cout are zero-filled in shared memory, the partials
//     padded to whole 64 x 64 tiles, and when d >= T the shifted taps see no
//     valid row and are written as zero.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaGetLastError() of the launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;  // f32 path and the reduction
constexpr int TI = 64;        // f32 path: input channels per block
constexpr int TO = 64;        // f32 path: output channels per block
constexpr int TK = 32;        // f32 path: time rows per chunk
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

// ---- bf16: wgmma on TMA-fed tiles ----------------------------------------------
namespace dwb {
constexpr int R = 64;                 // time rows a stage: four 16-deep wgmma steps
constexpr int TM = 64;                // input channels a block (wgmma m)
constexpr int TN = 128;               // output channels a block (wgmma n)
constexpr int STAGES = 4;
constexpr int BOX = R * 128;          // one 64-channel x R-row box, 128-byte swizzled: 8 KB
constexpr int STAGE = 5 * BOX;        // g's 128 channels (two boxes), then x at taps 0, 1, 2
constexpr int THREADS = 3 * 128 + 32;  // a consumer warpgroup a tap, then one producer warp
constexpr size_t SMEM = (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t) + 1024;
}  // namespace dwb

// Block (co tile, ci tile, split s): the 64 x 128 tile of all three dW_j over
// the recordings of split s. The producer thread walks (recording, 64-row
// chunk) steps and loads, per step, g's chunk once and x's chunk once per
// tap at t0 + (j - 1) d, each by its own TMA load (rows outside the
// recording arrive as zero). Warpgroup j multiplies X_jᵀ (64 x 64, MN-major:
// x's channels are contiguous) by G (64 x 128, MN-major) into its own
// accumulator. Empty barriers take one arrival per consumer warp.
__global__ void __launch_bounds__(dwb::THREADS, 1)
tap_conv_dw_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap gmap,
                        float* __restrict__ part, Geo geo) {
  using namespace dwb;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  const int co0 = blockIdx.x * TN, ci0 = blockIdx.y * TM, s = blockIdx.z;
  int b0, b1;
  split_rows(geo, s, b0, b1);
  const int per_rec = (geo.T + R - 1) / R;
  const int steps = (b1 - b0) * per_rec;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 12);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 3) {  // producer warp: one thread issues every load
    if (threadIdx.x == 3 * 128) {
      for (int k = 0; k < steps; ++k) {
        const int st = k % STAGES;
        if (k >= STAGES) hopper::mbar_wait(&empty[st], (k / STAGES - 1) & 1);
        unsigned char* tile = smem + (size_t)st * STAGE;
        const int b = b0 + k / per_rec, t0 = (k % per_rec) * R;
        hopper::mbar_arrive_expect(&full[st], STAGE);
        hopper::tma_load_3d(tile, &gmap, &full[st], co0, t0, b);
        hopper::tma_load_3d(tile + BOX, &gmap, &full[st], co0 + 64, t0, b);
        for (int j = 0; j < 3; ++j)
          hopper::tma_load_3d(tile + (2 + j) * BOX, &xmap, &full[st], ci0, t0 + (j - 1) * geo.d, b);
      }
    }
    return;
  }

  const int j = wg;  // this warpgroup's tap
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  for (int k = 0; k < steps; ++k) {
    const int st = k % STAGES;
    hopper::mbar_wait(&full[st], (k / STAGES) & 1);
    const unsigned char* g_t = smem + (size_t)st * STAGE;
    const unsigned char* x_t = g_t + (2 + j) * BOX;
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      // 16 rows deeper: 2048 bytes on; A is one 64-wide block, B two (BOX apart)
      const uint64_t da = hopper::desc_sw128(x_t + kk * 2048, BOX, 1024);
      const uint64_t db = hopper::desc_sw128(g_t + kk * 2048, BOX, 1024);
      hopper::wgmma_m64n128k16<1, 1>(acc, da, db);
    }
    hopper::wgmma_commit();
    // the stage goes back to the producer as soon as its products are done
    // (three warpgroups keep the tensor cores fed; holding a step in flight
    // measured slower)
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[st]);
  }

  // accumulator fragment: warp w holds rows 16w .. 16w + 15; register 4c + e
  // is row lane / 4 (+ 8 for e >= 2), column 8c + 2 (lane % 4) + e % 2
  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row = ci0 + 16 * w + lane / 4;
  float* pj = part + (size_t)(s * 3 + j) * geo.cin_pad * geo.cout_pad;
#pragma unroll
  for (int c = 0; c < TN / 8; ++c) {
    const int col = co0 + 8 * c + 2 * (lane % 4);
    *reinterpret_cast<float2*>(pj + (size_t)row * geo.cout_pad + col) = make_float2(acc[4 * c], acc[4 * c + 1]);
    *reinterpret_cast<float2*>(pj + (size_t)(row + 8) * geo.cout_pad + col) =
        make_float2(acc[4 * c + 2], acc[4 * c + 3]);
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

// the fixed-order reduction of the splits' partials into out
int reduce_splits(const void* part, void* out, const Geo& geo, void* stream) {
  const size_t n = (size_t)3 * geo.Cin * geo.Cout;
  const int blocks = (int)((n + THREADS - 1) / THREADS < 1024 ? (n + THREADS - 1) / THREADS : 1024);
  reduce_splits_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>((const float*)part, (float*)out, geo);
  return (int)cudaGetLastError();
}

// f32: the dW kernel on the grid of geo, then the fixed-order reduction
int launch_f32(const void* x, const void* g, void* part, void* out, const Geo& geo, void* stream) {
  const size_t smem = (size_t)(TK + 2 * geo.dd + TK) * LDF * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(tap_conv_dw_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(geo.cout_pad / TO, geo.cin_pad / TI, geo.nsplit);
  tap_conv_dw_f32_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>((const float*)x, (const float*)g,
                                                                          (float*)part, geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_splits(part, out, geo, stream);
}

}  // namespace

// x (B, T, cin_ld) and g (B, T, cout_ld) bf16, channels zero-padded to
// cin_ld, cout_ld (multiples of 8), bases 16-byte aligned; part: nsplit x 3 x
// round64(Cin) x round128(Cout) f32 scratch; out: 3 x Cin x Cout f32
extern "C" int tap_conv_dw_bf16(const void* x, const void* g, void* part, void* out, int B, int Tlen, int Cin,
                                int Cout, int cin_ld, int cout_ld, int d, int nsplit, void* stream) {
  Geo geo = geometry(B, Tlen, Cin, Cout, d, nsplit);
  geo.cout_pad = (Cout + dwb::TN - 1) / dwb::TN * dwb::TN;
  CUtensorMap xmap, gmap;
  if (!hopper::make_map_bf16(&xmap, x, cin_ld, Tlen, B, dwb::R) ||
      !hopper::make_map_bf16(&gmap, g, cout_ld, Tlen, B, dwb::R))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tap_conv_dw_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dwb::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(geo.cout_pad / dwb::TN, geo.cin_pad / dwb::TM, nsplit);
  tap_conv_dw_bf16_kernel<<<grid, dwb::THREADS, dwb::SMEM, (cudaStream_t)stream>>>(xmap, gmap, (float*)part, geo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce_splits(part, out, geo, stream);
}

// x (B, T, Cin), g (B, T, Cout) f32; part: nsplit x 3 x round64(Cin) x
// round64(Cout) f32 scratch; out: 3 x Cin x Cout f32
extern "C" int tap_conv_dw_f32(const void* x, const void* g, void* part, void* out, int B, int Tlen, int Cin,
                               int Cout, int d, int nsplit, void* stream) {
  return launch_f32(x, g, part, out, geometry(B, Tlen, Cin, Cout, d, nsplit), stream);
}
