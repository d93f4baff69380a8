// The GLU at the end of the module path's ConvBlock, h = a · σ(b) with
// [a | b] = Y split over the last dim, forward and backward: bf16 rows of 2D
// channels in (D % 8 == 0, 16-byte-aligned bases), rows of D out.
//
// Replaces no Pallas kernel: the JAX package leaves the module path's GLU,
// a * jax.nn.sigmoid(b) (models/brain_encoder.py:481), to XLA, and K6's GLU
// epilogue (conv_block_train.cu, for ops/pallas/conv_block_train.py) is its
// fused path's counterpart. Bound by bytes: forward it must read Y (2U) and
// write h (U), backward read g (U) and Y (2U) and write dY (2U), with U =
// B·T·D bf16, 8 × 59 MB a block at the flagship (B = 256, T = 360, D = 320),
// 0.141 ms at 3.35 TB/s. PyTorch's eager chain ran a strided sigmoid and
// multiply forward, and backward two multiplies, sigmoid_backward and the cat
// of the two half-gradients, ~19U with the saved sigmoid, much of it on
// ATen's non-vectorised path for strided operands.
//
//   forward   h  = bf16(a · σ(b))                          σ in f32, one rounding
//   backward  da = bf16(g · σ(b)), db = bf16(g · a · σ(b) · (1 − σ(b)))
//             σ recomputed from the saved Y, written straight into the two
//             halves of one dY: no cat, no saved sigmoid
// A thread takes 8 channels of a row of h (16-byte loads of a, b and g, a
// 16-byte store a half), UNROLL items' loads in flight before it uses them.
// Each kernel launches as many blocks as the card holds at once and walks
// every gridDim-th item (one wave, no tail), as batchnorm_gelu.cu's row
// passes do. σ is tap3::sigmoid, 1 / (1 + expf(−b)); the stores round two
// values an instruction (cvt.rn.bf16x2.f32, as tap3::rnd2 does). No
// allocation and no host synchronisation: a CUDA graph captures both launches
// as they are, and two calls give the same bits.

#include "tap3.cuh"

using tap3::bf16;
using tap3::sigmoid;

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // items whose 16-byte loads a thread issues before it uses them

// item i of rows · D8 (D8 = D / 8): row r = i / D8, channels 8c..8c + 7 of
// h (and g), c = i − r · D8; a and b at 16-byte offsets r · 2D8 + c and + D8
__device__ __forceinline__ unsigned a_at(unsigned i, unsigned D8) {
  const unsigned r = i / D8;
  return i + r * D8;
}

__global__ void __launch_bounds__(THREADS) glu_fwd_kernel(const uint4* __restrict__ y, uint4* __restrict__ h,
                                                          unsigned n, unsigned D8) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += UNROLL * stride) {
    uint4 va[UNROLL], vb[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const unsigned k = i + j * stride;
      if (k < n) {
        const unsigned o = a_at(k, D8);
        va[j] = y[o];
        vb[j] = y[o + D8];
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const unsigned k = i + j * stride;
      if (k >= n) break;
      const __nv_bfloat162 *a = reinterpret_cast<const __nv_bfloat162*>(&va[j]),
                           *b = reinterpret_cast<const __nv_bfloat162*>(&vb[j]);
      uint4 out;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 av = __bfloat1622float2(a[q]), bv = __bfloat1622float2(b[q]);
        o[q] = __floats2bfloat162_rn(av.x * sigmoid(bv.x), av.y * sigmoid(bv.y));
      }
      h[k] = out;
    }
  }
}

__global__ void __launch_bounds__(THREADS) glu_bwd_kernel(const uint4* __restrict__ g, const uint4* __restrict__ y,
                                                          uint4* __restrict__ dy, unsigned n, unsigned D8) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += UNROLL * stride) {
    uint4 vg[UNROLL], va[UNROLL], vb[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const unsigned k = i + j * stride;
      if (k < n) {
        const unsigned o = a_at(k, D8);
        vg[j] = g[k];
        va[j] = y[o];
        vb[j] = y[o + D8];
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const unsigned k = i + j * stride;
      if (k >= n) break;
      const __nv_bfloat162 *gg = reinterpret_cast<const __nv_bfloat162*>(&vg[j]),
                           *a = reinterpret_cast<const __nv_bfloat162*>(&va[j]),
                           *b = reinterpret_cast<const __nv_bfloat162*>(&vb[j]);
      uint4 da, db;
      __nv_bfloat162 *oa = reinterpret_cast<__nv_bfloat162*>(&da), *ob = reinterpret_cast<__nv_bfloat162*>(&db);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 gv = __bfloat1622float2(gg[q]), av = __bfloat1622float2(a[q]), bv = __bfloat1622float2(b[q]);
        const float sx = sigmoid(bv.x), sy = sigmoid(bv.y);
        const float ax = gv.x * sx, ay = gv.y * sy;
        oa[q] = __floats2bfloat162_rn(ax, ay);
        ob[q] = __floats2bfloat162_rn(ax * av.x * (1.f - sx), ay * av.y * (1.f - sy));
      }
      const unsigned o = a_at(k, D8);
      dy[o] = da;
      dy[o + D8] = db;
    }
  }
}

// Blocks of a pass: as many as the card holds at once, fewer where the items
// need fewer. The occupancy is read once a kernel, on its first (eager) call.
template <typename Kernel>
static int grid_of(Kernel kernel, int& occ, unsigned n, int sms) {
  if (occ == 0 && (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS, 0) != cudaSuccess ||
                   occ < 1))
    occ = 1;
  const unsigned need = (n + THREADS - 1) / THREADS, cap = (unsigned)occ * (unsigned)sms;
  return (int)(need < cap ? need : cap);
}

static int occ_fwd, occ_bwd;

// the items of a call: rows · D / 8, below 2^31 so that i + UNROLL · stride cannot wrap
static bool items(int rows, int D, unsigned& n) {
  if (rows < 0 || D <= 0 || D % 8 != 0) return false;
  const unsigned long long m = (unsigned long long)rows * (unsigned)(D / 8);
  if (m >= (1ull << 31)) return false;
  n = (unsigned)m;
  return true;
}

// h (rows, D) = a · σ(b), [a | b] = y (rows, 2D)
extern "C" int glu_fwd(const void* y, void* h, int rows, int D, int sms, void* stream) {
  unsigned n;
  if (!items(rows, D, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  glu_fwd_kernel<<<grid_of(glu_fwd_kernel, occ_fwd, n, sms), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)y, (uint4*)h, n, (unsigned)(D / 8));
  return (int)cudaGetLastError();
}

// dy (rows, 2D) = [g · σ(b) | g · a · σ(b) · (1 − σ(b))] from g (rows, D) and y (rows, 2D)
extern "C" int glu_bwd(const void* g, const void* y, void* dy, int rows, int D, int sms, void* stream) {
  unsigned n;
  if (!items(rows, D, n)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  glu_bwd_kernel<<<grid_of(glu_bwd_kernel, occ_bwd, n, sms), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)g, (const uint4*)y, (uint4*)dy, n, (unsigned)(D / 8));
  return (int)cudaGetLastError();
}
