// Train-mode BatchNorm followed by GELU, h = GELU(BN(y)), for the module
// path's ConvBlock (two a block), forward and backward: bf16 activations
// (B·T rows of C channels, C % 8 == 0, 16-byte-aligned bases), f32
// statistics and parameters. Optionally y = a + skip, the block's residual,
// is formed by the first pass.
//
// Replaces no Pallas kernel: the JAX package leaves the module path's
// BatchNorm (models/brain_encoder.py:71 TorchBatchNorm) to XLA, and K6's
// epilogues (conv_block_train.cu, for ops/pallas/conv_block_train.py) are its
// fused path's counterpart. Bound by bytes: forward it must read y and write h,
// backward read dh and y and write dy, 5 x 59 MB a layer at the flagship
// (B = 256, T = 360, C = 320), 88 us at 3.35 TB/s, where PyTorch's eager
// train-mode BatchNorm and GELU ran ~50 launches and ~65 such tensors.
//
// Two passes each way, because the batch statistics are a global barrier:
//   forward   stats:    Σy, Σy² per (block, channel)            (y = a + skip written here)
//             finalize: mean, var, inv in a fixed order; running statistics moved
//             apply:    h = GELU(BN(y)) in bf16
//   backward  sums:     du = dh · GELU'(u) recomputed in f32; Σdu, Σdu·x̂ per (block, channel)
//             finalize: dbias = Σdu, dscale = Σdu·x̂, and the constants of dy
//             dy:       dy = bf16(inv0 · (scale · du − c1 − x̂ · c2)), du recomputed
// A thread takes 8 channels of a row (16-byte loads), with its channels'
// constants loaded once, and UNROLL rows' loads in flight. Each row pass
// launches as many blocks as the card holds at once, each walking every
// gridDim-th group of rows (one wave, no tail); a sum pass's block writes
// its per-channel sums to its own slot, and the finalize kernels add the
// slots in a fixed order. No float atomics, no allocation and no host
// synchronisation: two calls on one card give the same bits, and a CUDA
// graph captures the six launches as they are.
//
// Numerics follow TorchBatchNorm then GELU in bf16: statistics in f32 from
// the bf16 y (mean, E[y²] − mean², inv = rsqrt(var + eps) · scale), the
// normalisation with PyTorch's three roundings, bf16(bf16(bf16(y − mean) ·
// inv) + bias), each constant rounded to bf16 first, then GELU in f32
// rounded once. The backward is in f32 with one rounding, where autograd
// rounds at every op: x̂ = (y − mean) · inv0 and u = x̂ · scale + bias in f32.
// GELU and GELU' take erf from one exp (tap3::gelu_as and dgelu_as,
// Abramowitz–Stegun 7.1.26, |err| ≤ 1.5e-7, as the JAX package's Pallas
// kernels do): with erff and expf (tap3::gelu, dgelu) every element cost
// enough instructions to hold the apply and backward passes to about half
// the card's bandwidth. tap3::bn_const and bn_apply are not used: they round
// K6's sequence, bf16(bf16(bf16(bf16(y − mean) · inv0) · scale) + bias),
// four roundings with the scale apart, where TorchBatchNorm folds the scale
// into inv and rounds three times; and the apply pass rounds two values an
// instruction (tap3::rnd2), which the scalar bn_apply does not.

#include "tap3.cuh"

using tap3::bf16;
using tap3::dgelu_as;
using tap3::from_f;
using tap3::gelu_as;
using tap3::rnd;
using tap3::rnd2;
using tap3::to_f;

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 8;  // blocks an SM of a row pass, at most: its slots of partial sums
constexpr int UNROLL = 4;  // 16-byte loads a thread issues before it uses them
constexpr int UNROLL_SUMS = 2;  // the backward sums' (under its register cap)
constexpr int FIN_CH = 32;  // channels of a finalize block, one a lane
constexpr int FIN_WAYS = 32;  // warps of a finalize block: slots w, w + 32, ...

__device__ __forceinline__ const uint4* row16(const bf16* p) { return reinterpret_cast<const uint4*>(p); }

// A sum pass's end: thread (g, r) holds 8 channels' two sums (s: 16 floats);
// the block adds them over r in order into its slot, part[block] = [Σ0 (C);
// Σ1 (C)].
__device__ __forceinline__ void block_sums(float* red, const float* s, float* part, int C, int C8, int per, int g,
                                          int r0) {
#pragma unroll
  for (int q = 0; q < 16; ++q) red[threadIdx.x * 16 + q] = s[q];
  __syncthreads();
  if (r0 != 0) return;
  float* p = part + (size_t)blockIdx.x * 2 * C;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float a = 0.f, b = 0.f;
    for (int rr = 0; rr < per; ++rr) {
      a += red[(rr * C8 + g) * 16 + q];
      b += red[(rr * C8 + g) * 16 + 8 + q];
    }
    p[8 * g + q] = a;
    p[C + 8 * g + q] = b;
  }
}

// The finalize kernels' sums: channel blockIdx.x · FIN_CH + lane of both
// halves of every slot, warp w taking slots w, w + FIN_WAYS, ..., then
// the warps' sums in order. Every thread of the block returns; only lanes of
// warp 0 with c < C hold the totals.
__device__ __forceinline__ bool slot_sums(const float* part, int slots, int C, float& s0, float& s1) {
  __shared__ float red[2][FIN_WAYS][FIN_CH];
  const int lane = threadIdx.x % FIN_CH, w = threadIdx.x / FIN_CH, c = blockIdx.x * FIN_CH + lane;
  float a = 0.f, b = 0.f;
  if (c < C)
    for (int t = w; t < slots; t += FIN_WAYS) {
      a += part[(size_t)t * 2 * C + c];
      b += part[(size_t)t * 2 * C + C + c];
    }
  red[0][w][lane] = a;
  red[1][w][lane] = b;
  __syncthreads();
  if (w != 0 || c >= C) return false;
  s0 = s1 = 0.f;
#pragma unroll
  for (int i = 0; i < FIN_WAYS; ++i) {
    s0 += red[0][i][lane];
    s1 += red[1][i][lane];
  }
  return true;
}

// forward pass 1: Σy and Σy² of the block's rows; with skip, y = bf16(a + skip) written first
__global__ void __launch_bounds__(THREADS) bngelu_stats_kernel(const bf16* __restrict__ a,
                                                               const bf16* __restrict__ skip, bf16* __restrict__ y,
                                                               float* __restrict__ part, int rows, int C) {
  __shared__ float red[THREADS * 16];
  const int C8 = C / 8, per = blockDim.x / C8, g = threadIdx.x % C8, r0 = threadIdx.x / C8;
  const int stride = gridDim.x * per;
  float s[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) s[q] = 0.f;
  for (int r = blockIdx.x * per + r0; r < rows; r += UNROLL * stride) {
    uint4 va[UNROLL], vs[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const size_t i = (size_t)(r + j * stride) * C8 + g;
      if (r + j * stride < rows) {
        va[j] = row16(a)[i];
        if (skip) vs[j] = row16(skip)[i];
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (r + j * stride >= rows) break;
      bf16* e = reinterpret_cast<bf16*>(&va[j]);
      if (skip) {
        const bf16* f = reinterpret_cast<const bf16*>(&vs[j]);
#pragma unroll
        for (int q = 0; q < 8; ++q) e[q] = from_f<bf16>(to_f(e[q]) + to_f(f[q]));
        reinterpret_cast<uint4*>(y)[(size_t)(r + j * stride) * C8 + g] = va[j];
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float v = to_f(e[q]);
        s[q] += v;
        s[8 + q] += v * v;
      }
    }
  }
  block_sums(red, s, part, C, C8, per, g, r0);
}

// forward finalize: st = [mean; inv0 · scale; inv0]; unless rmean is null (a
// remat recomputation), the running statistics move as TorchBatchNorm moves
// them, each op rounded as PyTorch rounds it
__global__ void __launch_bounds__(FIN_CH * FIN_WAYS) bngelu_finalize_kernel(
    const float* __restrict__ part, int slots, int C, float n, float bessel, float eps, float keep, float momentum,
    const float* __restrict__ scale, float* __restrict__ st, float* rmean, float* rvar) {
  float s0, s1;
  if (!slot_sums(part, slots, C, s0, s1)) return;
  const int c = blockIdx.x * FIN_CH + threadIdx.x;
  const float mean = __fdiv_rn(s0, n);
  const float var = __fsub_rn(__fdiv_rn(s1, n), __fmul_rn(mean, mean));
  const float inv0 = rsqrtf(__fadd_rn(var, eps));
  st[c] = mean;
  st[C + c] = __fmul_rn(inv0, scale[c]);
  st[2 * C + c] = inv0;
  if (rmean) {
    rmean[c] = __fadd_rn(__fmul_rn(rmean[c], keep), __fmul_rn(momentum, mean));
    rvar[c] = __fadd_rn(__fmul_rn(rvar[c], keep), __fmul_rn(momentum, __fmul_rn(var, bessel)));
  }
}

// The pointwise passes (apply, dy) walk the rows from the last: the sum pass
// before them walked from the first, so the rows it read last, which L2 may
// still hold, are read first.
__device__ __forceinline__ size_t rev(int rows, int r, int C8, int g) { return (size_t)(rows - 1 - r) * C8 + g; }

// forward pass 2: h = GELU(BN(y)) in bf16, the normalisation as the module
// path rounds it, u = bf16(bf16(bf16(y − mean) · inv) + bias), each constant
// rounded to bf16 first (st holds [mean; inv; inv0], inv with scale folded
// in, as TorchBatchNorm folds it), then GELU in f32 rounded once
__global__ void __launch_bounds__(THREADS) bngelu_apply_kernel(const bf16* __restrict__ y,
                                                               const float* __restrict__ st,
                                                               const float* __restrict__ bias,
                                                               bf16* __restrict__ h, int rows, int C) {
  const int C8 = C / 8, per = blockDim.x / C8, g = threadIdx.x % C8, r0 = threadIdx.x / C8;
  float m[8], k[8], b[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int c = 8 * g + q;
    m[q] = rnd<bf16>(tap3::ldg(st + c));
    k[q] = rnd<bf16>(tap3::ldg(st + C + c));
    b[q] = rnd<bf16>(tap3::ldg(bias + c));
  }
  const int stride = gridDim.x * per;
  for (int r = blockIdx.x * per + r0; r < rows; r += UNROLL * stride) {
    uint4 v[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j)
      if (r + j * stride < rows) v[j] = row16(y)[rev(rows, r + j * stride, C8, g)];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (r + j * stride >= rows) break;
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v[j]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 yv = __bfloat1622float2(e[q]);
        const float2 d = rnd2(yv.x - m[2 * q], yv.y - m[2 * q + 1]);
        const float2 x = rnd2(d.x * k[2 * q], d.y * k[2 * q + 1]);
        const float2 u = rnd2(x.x + b[2 * q], x.y + b[2 * q + 1]);
        e[q] = __floats2bfloat162_rn(gelu_as(u.x), gelu_as(u.y));
      }
      reinterpret_cast<uint4*>(h)[rev(rows, r + j * stride, C8, g)] = v[j];
    }
  }
}

// The backward's per-thread constants of its 8 channels, and its
// recomputation, the same in both passes: x̂ = (y − mean) · inv0 and du = dh ·
// GELU'(x̂ · scale + bias), in f32
struct BwdConst {
  float m[8], inv0[8], g[8], b[8];
  __device__ __forceinline__ BwdConst(const float* st, const float* scale, const float* bias, int C, int g8) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int c = 8 * g8 + q;
      m[q] = tap3::ldg(st + c);
      inv0[q] = tap3::ldg(st + 2 * C + c);
      g[q] = tap3::ldg(scale + c);
      b[q] = tap3::ldg(bias + c);
    }
  }
  __device__ __forceinline__ void recompute(float dh, float y, int q, float& du, float& xhat) const {
    xhat = (y - m[q]) * inv0[q];
    du = dh * dgelu_as(fmaf(xhat, g[q], b[q]));
  }
};

// backward pass 1: Σdu and Σdu·x̂ of the block's rows. Registers capped for
// three blocks an SM.
__global__ void __launch_bounds__(THREADS, 3) bngelu_bwd_sums_kernel(const bf16* __restrict__ dh,
                                                                  const bf16* __restrict__ y,
                                                                  const float* __restrict__ st,
                                                                  const float* __restrict__ scale,
                                                                  const float* __restrict__ bias,
                                                                  float* __restrict__ part, int rows, int C) {
  __shared__ float red[THREADS * 16];
  const int C8 = C / 8, per = blockDim.x / C8, g = threadIdx.x % C8, r0 = threadIdx.x / C8;
  const int stride = gridDim.x * per;
  const BwdConst k(st, scale, bias, C, g);
  float s[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) s[q] = 0.f;
  for (int r = blockIdx.x * per + r0; r < rows; r += UNROLL_SUMS * stride) {
    uint4 vd[UNROLL_SUMS], vy[UNROLL_SUMS];
#pragma unroll
    for (int j = 0; j < UNROLL_SUMS; ++j) {
      const size_t i = (size_t)(r + j * stride) * C8 + g;
      if (r + j * stride < rows) {
        vd[j] = row16(dh)[i];
        vy[j] = row16(y)[i];
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL_SUMS; ++j) {
      if (r + j * stride >= rows) break;
      const bf16 *d = reinterpret_cast<const bf16*>(&vd[j]), *e = reinterpret_cast<const bf16*>(&vy[j]);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float du, xhat;
        k.recompute(to_f(d[q]), to_f(e[q]), q, du, xhat);
        s[q] += du;
        s[8 + q] += du * xhat;
      }
    }
  }
  block_sums(red, s, part, C, C8, per, g, r0);
}

// backward finalize: dbias = Σdu, dscale = Σdu·x̂, cst = [scale·Σdu/n; scale·Σdu·x̂/n]
__global__ void __launch_bounds__(FIN_CH * FIN_WAYS) bngelu_bwd_finalize_kernel(
    const float* __restrict__ part, int slots, int C, float n, const float* __restrict__ scale,
    float* __restrict__ dscale, float* __restrict__ dbias, float* __restrict__ cst) {
  float s0, s1;
  if (!slot_sums(part, slots, C, s0, s1)) return;
  const int c = blockIdx.x * FIN_CH + threadIdx.x;
  dbias[c] = s0;
  dscale[c] = s1;
  cst[c] = __fdiv_rn(__fmul_rn(scale[c], s0), n);
  cst[C + c] = __fdiv_rn(__fmul_rn(scale[c], s1), n);
}

// backward pass 2: dy = bf16(inv0 · (scale · du − c1 − x̂ · c2))
__global__ void __launch_bounds__(THREADS) bngelu_bwd_dy_kernel(const bf16* __restrict__ dh,
                                                                const bf16* __restrict__ y,
                                                                const float* __restrict__ st,
                                                                const float* __restrict__ bias,
                                                                const float* __restrict__ scale,
                                                                const float* __restrict__ cst,
                                                                bf16* __restrict__ dy, int rows, int C) {
  const int C8 = C / 8, per = blockDim.x / C8, g = threadIdx.x % C8, r0 = threadIdx.x / C8;
  const BwdConst k(st, scale, bias, C, g);
  float c1[8], c2[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    c1[q] = tap3::ldg(cst + 8 * g + q);
    c2[q] = tap3::ldg(cst + C + 8 * g + q);
  }
  const int stride = gridDim.x * per;
  for (int r = blockIdx.x * per + r0; r < rows; r += UNROLL * stride) {
    uint4 vd[UNROLL], vy[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const size_t i = rev(rows, r + j * stride, C8, g);
      if (r + j * stride < rows) {
        vd[j] = row16(dh)[i];
        vy[j] = row16(y)[i];
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (r + j * stride >= rows) break;
      const bf16 *d = reinterpret_cast<const bf16*>(&vd[j]), *e = reinterpret_cast<const bf16*>(&vy[j]);
      uint4 out;
      bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float du, xhat;
        k.recompute(to_f(d[q]), to_f(e[q]), q, du, xhat);
        o[q] = from_f<bf16>(k.inv0[q] * (k.g[q] * du - c1[q] - xhat * c2[q]));
      }
      reinterpret_cast<uint4*>(dy)[rev(rows, r + j * stride, C8, g)] = out;
    }
  }
}

// Blocks of a row pass: as many as the card holds at once (at most
// MAX_BLOCKS an SM), each walking every gridDim-th group of rows, so the
// pass is one wave with no tail; fewer where the rows need fewer. The
// occupancy is read once a kernel, on its first (eager) call.
template <typename Kernel>
static int row_grid(Kernel kernel, int& occ, int threads, int rows, int per, int sms) {
  if (occ == 0 && (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, 0) != cudaSuccess ||
                   occ < 1))
    occ = 1;
  const int cap = (occ < MAX_BLOCKS ? occ : MAX_BLOCKS) * sms, need = (rows + per - 1) / per;
  return need < cap ? need : cap;
}

static int occ_stats, occ_apply, occ_sums, occ_dy;

#define CHECK_LAUNCH()                         \
  do {                                         \
    const cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)

// h = GELU(BN(y)), y = a (skip null) or bf16(a + skip) written to y. part:
// MAX_BLOCKS · sms · 2C f32 scratch; st (3, C) f32 out. rmean and rvar: the
// running statistics, moved in place, or null to leave them (a remat
// recomputation).
extern "C" int bngelu_fwd(const void* a, const void* skip, const void* scale, const void* bias, void* y, void* h,
                          void* part, void* st, void* rmean, void* rvar, int rows, int C, int sms, double eps,
                          double momentum, void* stream) {
  const int C8 = C / 8;
  if (C % 8 != 0 || C8 == 0 || C8 > THREADS) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int per = THREADS / C8, slots = row_grid(bngelu_stats_kernel, occ_stats, per * C8, rows, per, sms);
  bngelu_stats_kernel<<<slots, per * C8, 0, s>>>((const bf16*)a, (const bf16*)skip, (bf16*)y, (float*)part, rows, C);
  CHECK_LAUNCH();
  // PyTorch's scalars: n / (n − 1) and 1 − momentum in double, each then cast to f32
  const double n = rows;
  bngelu_finalize_kernel<<<(C + FIN_CH - 1) / FIN_CH, FIN_CH * FIN_WAYS, 0, s>>>(
      (const float*)part, slots, C, (float)n, (float)(n / (rows > 1 ? n - 1 : 1.0)), (float)eps,
      (float)(1.0 - momentum), (float)momentum, (const float*)scale, (float*)st, (float*)rmean, (float*)rvar);
  CHECK_LAUNCH();
  bngelu_apply_kernel<<<row_grid(bngelu_apply_kernel, occ_apply, per * C8, rows, per, sms), per * C8, 0, s>>>(
      (const bf16*)y, (const float*)st, (const float*)bias, (bf16*)h, rows, C);
  CHECK_LAUNCH();
  return (int)cudaSuccess;
}

// dy from dh, the saved y and st; dscale and dbias (C) f32 out. part:
// MAX_BLOCKS · sms · 2C f32 scratch, cst: 2C f32 scratch.
extern "C" int bngelu_bwd(const void* dh, const void* y, const void* st, const void* bias, const void* scale,
                          void* part, void* cst, void* dscale, void* dbias, void* dy, int rows, int C, int sms,
                          void* stream) {
  const int C8 = C / 8;
  if (C % 8 != 0 || C8 == 0 || C8 > THREADS) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int per = THREADS / C8, slots = row_grid(bngelu_bwd_sums_kernel, occ_sums, per * C8, rows, per, sms);
  bngelu_bwd_sums_kernel<<<slots, per * C8, 0, s>>>((const bf16*)dh, (const bf16*)y, (const float*)st,
                                                    (const float*)scale, (const float*)bias, (float*)part, rows, C);
  CHECK_LAUNCH();
  bngelu_bwd_finalize_kernel<<<(C + FIN_CH - 1) / FIN_CH, FIN_CH * FIN_WAYS, 0, s>>>(
      (const float*)part, slots, C, (float)rows, (const float*)scale, (float*)dscale, (float*)dbias, (float*)cst);
  CHECK_LAUNCH();
  bngelu_bwd_dy_kernel<<<row_grid(bngelu_bwd_dy_kernel, occ_dy, per * C8, rows, per, sms), per * C8, 0, s>>>(
      (const bf16*)dh, (const bf16*)y, (const float*)st, (const float*)bias, (const float*)scale, (const float*)cst,
      (bf16*)dy, rows, C);
  CHECK_LAUNCH();
  return (int)cudaSuccess;
}
