// K6: the train-mode ConvBlock, three stages a direction, one per BatchNorm
// sync point (the O(C) statistics math between them runs as PyTorch ops):
//   F1: y0 = conv_d0(x) + b0 (+ x)                  -> y0 (dt); sums of y0, y0^2
//   F2: h0 = GELU(BN0(y0)); y1 = conv_d1(h0) + b1 + h0 -> y1 (dt); sums
//   F3: h1 = GELU(BN1(y1)); out = GLU(conv_2(h1) + b2) -> out (dt)
//   B1: GLU and conv2 backward, GELU·BN1 input backward -> du1; dy2, h1 for dW2
//   B2: BN1 backward -> dy1; conv1 backward + skip, GELU·BN0 backward -> du0
//   B3: BN0 backward -> dy0; conv0 backward (+ skip) -> dx
// with dt the compute dtype (f32 or bf16), f32 statistics, BN applied in dt,
// exact GELU (erff here, where the Pallas kernels build erf from exp), f32
// accumulation, and the rounding points of the Pallas bodies.
//
// Replaces the Pallas TPU kernels speech_decoding_tpu/ops/pallas/
// conv_block_train.py (_fwd_impl: _f1_kernel, _f2_kernel, _f3_kernel;
// _bwd_rule: _b1_kernel, _b2_kernel, _b3_kernel). Those keep four whole
// recordings and every weight in VMEM and carry the BN sums, dW and db
// across a sequential grid. Here every sum is a per-block f32 partial added
// in a fixed order by tap3::reduce_parts: bitwise repeatable, no float
// atomics. Every conv runs one of two bodies, with the same per-element
// epilogues (the functors F1 .. B3c below, so the rounding points are the
// same on both):
//   * bf16 (cbt_*_wg): conv_wg (conv_wg.cuh, shared with K4), the
//     persistent TMA + mbarrier + wgmma implicit GEMM of K5 (tap_conv.cu, on
//     hopper.cuh) with a 192-time x 160-column tile, templated on the
//     epilogue, which works on the accumulator fragments
//     (a warp wholly inside the output runs the light epilogues without a
//     guard, so their loads overlap). TMA lands the conv's input in
//     swizzled shared memory untouched, so the BN·GELU of F2, F3 and B1 is
//     a pointwise pass that writes h0 or h1 once (bn_gelu_kernel; the same
//     values tap3's prologue computes), and the conv reads h, whose rows
//     outside [0, T) the tensor map reads as zero. The GLU conv (F3, B1)
//     reads w2 packed with channel c's value and gate columns side by side,
//     so one accumulator thread holds both. The BN-backward passes of B2 and
//     B3 read and write 16 bytes a row (bn_bwd_wg_kernel). A 270-channel x
//     (block 0) reaches F1 as a 272-channel copy made by the wrapper, which
//     B3's K2 launch reuses.
//   * f32, and bf16 outside the wrapper's route rule: the time tile of
//     tap3.cuh (a halo of d, weights streamed through shared memory, the
//     BN·GELU applied as the input is staged). K7's tap3 route runs on it
//     too, and the bf16 entries cbt_*_bf16 stay that route's bitwise partner.
//
// Where a stage splits (each stage is one call of its wrapper):
//   F1, F2: the conv with its epilogue, then the sums' reduction (wgmma:
//       F2 first writes h0).
//   F3: the conv (both GLU halves in one thread) with its epilogue (wgmma:
//       after writing h1).
//   B1: (a) h1 (tap3: dumped by the conv's prologue; wgmma: the pointwise
//       pass) and conv2, the GLU backward in the epilogue -> dy2 (B, T, 2C)
//       and db2's partials; (b) the wrapper takes dW2 = K2(h1, dy2, 2); (c)
//       the transposed conv of dy2 -> du1 and the BN1 sums. Extra traffic
//       against the Pallas body: h1 and dy2 written and read back (3 *
//       B*T*C elements written, 5 read).
//   B2: (a) a pointwise pass -> dy1 and h0 (for K2) and db1's partials; (b)
//       dW1 = K2(h0, dy1, d1) in the wrapper; (c) the transposed conv of dy1
//       + dy1 -> du0 and the BN0 sums. Extra: dy1 and h0, 2 written, 4 read.
//   B3: (a) a pointwise pass -> dy0 and db0's partials; (b) dW0 = K2(x, dy0,
//       d0); (c) the transposed conv of dy0 (+ dy0) -> dx. Extra: dy0, 1
//       written, 2 read.
//
// What bounds it on an H100: operations. At B = 64, T = 360, C = 320 a block
// with k >= 1 is 56.6 GFLOP forward (57 us at 989 TFLOP/s bf16) and 141.6
// GFLOP backward, of which the K2 launches are 42.5. On the wgmma route a
// block takes ~1.0 ms on the device of an NVIDIA H100 80GB HBM3 at 700 W,
// ~20% of that bound (PERF.md); the conv epilogues stall the tensor cores
// (one 416-thread block a SM, capped at 128 registers), and the pointwise
// passes and K2 are a third of it.
//
// K7: F3 of block k fused with F1 of block k+1, so that `out` is not read
// back from device memory by the next conv. Replaces the Pallas TPU kernel
// _f31_kernel of tools/bench_cross_block_merge.py (built at :109, measured
// there against the split pair F3 then F1). Two routes, as K6's stages:
//   * bf16 (cbt_f31_wg, the wrapper's route rule): one persistent launch on
//     conv_wg's tiles (f31_wg_kernel below) computes every F3 tile of block
//     k, then every F1 tile of block k+1 once the F3 tiles it reads are
//     done; `out` passes from the one to the other through L2 (14.7 MB at
//     the flagship against the H100's 50 MB) and is still written, since the
//     backward reads it. F1 reads every channel of `out` at t +- d0n, so
//     keeping a window of it in shared memory would need 224 x 320 bf16 (140
//     KB) next to conv_wg's 207 KB ring. Its tiles, products, epilogues and
//     sums are f3_wg's and f1_wg's, so out, y0n and s0n equal those of
//     cbt_f3_wg then cbt_f1_wg (the wgmma pair) bit for bit. It saves the
//     pair's second launch and wave tail and F1's read of `out` from HBM.
//   * f32, and bf16 outside the rule (cbt_f31_f32/_bf16, the first port): a
//     block owns 64 times of one recording across all C channels, recomputes
//     F3 over its window of 64 + 2 d0n rows (two 64-row passes of the tap3
//     tile, so F3's work doubles for every d0n <= 32), keeps that window of
//     `out` in shared memory in dt (zero outside the recording), writes its
//     own 64 rows to `out`, then runs F1's conv on the window. Both convs go
//     through tap3::Tile with the tap3 entries' chunk walk and tap order,
//     and the sums through the same per-(recording, tile) partials and
//     reduce_parts, so out, y0n and s0n equal those of cbt_f3 then cbt_f1
//     (the tap3 pair) bit for bit.
// Bound: operations, as the split pair (28.3 + 14.2 GFLOP at the flagship).
//
// C interface (ctypes): pointers and the stream as void*; each entry returns
// the first non-zero cudaError_t of its launches. `part` is f32 scratch of
// B * ceil(T / TM) * 2 * C elements for the conv tile's TM (64 on tap3, 192
// on wgmma), and at least B * ceil(T / 64) * C (the BN-backward pass's).

#include "conv_wg.cuh"
#include "hopper.cuh"
#include "tap3.cuh"

namespace {

using tap3::bf16;
using tap3::from_f;
using tap3::rnd;
using tap3::to_f;
using tap3::TM;
using tap3::TN;

// kStats: the epilogue's per-channel sums go to `part`; kUnguarded: the wgmma
// body may run it without a guard where a whole warp lies inside the output
// kCoherent (K7's wgmma route): the skip was written by other blocks of the
// same launch, so it is read with plain loads (ordered after those writes by
// the reading thread's acquire), not through the read-only path
template <typename T, bool kCoherent = false>
struct F1 {
  static constexpr bool kStats = true, kUnguarded = true;
  const float* bias; const T* skip; T* y; int T_, C;
  __device__ void operator()(int b, int t, int c, float v, float, float& s0, float& s1) const {
    const size_t i = ((size_t)b * T_ + t) * C + c;
    v += tap3::ldg(bias + c);
    if constexpr (kCoherent)
      v += to_f(skip[i]);
    else if (skip)
      v += tap3::ldg(skip + i);
    const T yc = from_f<T>(v);
    y[i] = yc;
    const float f = to_f(yc);
    s0 += f;
    s1 += f * f;
  }
};

// h0, the skip, is pro(src): BnGelu of y0 on tap3, the stored h0 on wgmma
template <typename T, class Pro>
struct F2 {
  static constexpr bool kStats = true, kUnguarded = true;
  const float* bias; const T* src; Pro pro; T* y1; int T_, C;
  __device__ void operator()(int b, int t, int c, float v, float, float& s0, float& s1) const {
    const size_t i = ((size_t)b * T_ + t) * C + c;
    const float h0 = pro(tap3::ldg(src + i), c);
    const T yc = from_f<T>(v + tap3::ldg(bias + c) + h0);
    y1[i] = yc;
    const float f = to_f(yc);
    s0 += f;
    s1 += f * f;
  }
};

template <typename T>
struct F3 {
  static constexpr bool kStats = false, kUnguarded = true;
  const float* b2; T* out; int T_, C;
  // out = dt(dt(a + b2[c]) * dt(sigmoid(g + b2[C + c]))): F3's and K7's GLU
  __device__ static T glu(float a, float g, const float* b2, int C, int c) {
    a += tap3::ldg(b2 + c);
    g += tap3::ldg(b2 + C + c);
    return from_f<T>(rnd<T>(a) * rnd<T>(tap3::sigmoid(g)));
  }
  __device__ void operator()(int b, int t, int c, float a, float g, float&, float&) const {
    out[((size_t)b * T_ + t) * C + c] = glu(a, g, b2, C, c);
  }
};

// GLU backward: dy2 = [dout * sig, dout * a * sig * (1 - sig)] in dt; sums for db2
template <typename T>
struct B1a {
  static constexpr bool kStats = true, kUnguarded = true;
  const float* b2; const T* dout; T* dy2; int T_, C;
  __device__ void operator()(int b, int t, int c, float a, float g, float& s0, float& s1) const {
    a += tap3::ldg(b2 + c);
    g += tap3::ldg(b2 + C + c);
    const float sig = tap3::sigmoid(g), df = tap3::ldg(dout + ((size_t)b * T_ + t) * C + c);
    const T da = from_f<T>(df * sig), db = from_f<T>(df * a * sig * (1.f - sig));
    T* row = dy2 + ((size_t)b * T_ + t) * 2 * C;
    row[c] = da;
    row[C + c] = db;
    s0 += to_f(da);
    s1 += to_f(db);
  }
};

// du = dt(dh * GELU'(u)), u and x̂ from BN applied in dt; sums of du and du·x̂
template <typename T>
struct GeluBnBwd {
  static constexpr bool kStats = true, kUnguarded = false;
  const T* skip; const T* y; const float* mi; const float* gb; T* du; int T_, C;
  __device__ void operator()(int b, int t, int c, float dh, float, float& s0, float& s1) const {
    const size_t i = ((size_t)b * T_ + t) * C + c;
    if (skip) dh += tap3::ldg(skip + i);
    float xhat, u;
    tap3::bn_apply<T>(tap3::ldg(y + i), c, mi, gb, C, xhat, u);
    const T v = from_f<T>(dh * tap3::dgelu(u));
    du[i] = v;
    s0 += to_f(v);
    s1 += to_f(v) * xhat;
  }
};

template <typename T>
struct B3c {
  static constexpr bool kStats = false, kUnguarded = true;
  const T* skip; T* dx; int T_, C;
  __device__ void operator()(int b, int t, int c, float v, float, float&, float&) const {
    const size_t i = ((size_t)b * T_ + t) * C + c;
    if (skip) v += tap3::ldg(skip + i);
    dx[i] = from_f<T>(v);
  }
};

// BN backward to the conv output: dy = dt(inv * (g * du - c1 - x̂ * c2)), x̂ in
// f32; with h set, also h = GELU(BN(yp)) of the conv's input for K2
template <typename T>
struct BnBwd {
  const T* du; const T* y; const float* mi; const float* gc; T* dy;
  const T* yp; const float* mip; const float* gbp; T* h;
  float* part; int T_, C, ntile;
};

template <typename T>
__global__ void __launch_bounds__(tap3::THREADS) bn_bwd_kernel(BnBwd<T> a) {
  __shared__ float red[2 * TN];
  const int c = threadIdx.x % TN, half = threadIdx.x / TN, co = blockIdx.x * TN + c;
  const int t0 = blockIdx.y * TM, b = blockIdx.z, C = a.C;
  float s = 0.f;
  if (co < C) {
    const float m = a.mi[co], inv = a.mi[C + co], g = a.gc[co], c1 = a.gc[C + co], c2 = a.gc[2 * C + co];
    for (int r = half * (TM / 2); r < (half + 1) * (TM / 2) && t0 + r < a.T_; ++r) {
      const size_t i = ((size_t)b * a.T_ + t0 + r) * C + co;
      const float xhat = (tap3::ldg(a.y + i) - m) * inv;
      const T v = from_f<T>(inv * (g * tap3::ldg(a.du + i) - c1 - xhat * c2));
      a.dy[i] = v;
      s += to_f(v);
      if (a.h) a.h[i] = from_f<T>(tap3::BnGelu<T>{a.mip, a.gbp, C}(tap3::ldg(a.yp + i), co));
    }
  }
  red[half * TN + c] = s;
  __syncthreads();
  if (half == 0 && co < C) a.part[((size_t)b * a.ntile + blockIdx.y) * C + co] = red[c] + red[TN + c];
}

template <typename T>
int bn_bwd(const BnBwd<T>& a, int B, cudaStream_t stream) {
  if ((long long)B * a.T_ == 0 || a.C == 0) return (int)cudaSuccess;
  bn_bwd_kernel<T><<<dim3((a.C + TN - 1) / TN, a.ntile, B), tap3::THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int f1(const void* x, const void* w0, const void* b0, void* y0, float* part, float* s0, int B, int Tlen, int Cin,
       int C, int d0, int skip, cudaStream_t st) {
  const tap3::Conv g = tap3::make_conv(B, Tlen, Cin, C, C, 0, d0, x, w0);
  CHECK((tap3::launch_conv<T, 1>(x, w0, g, tap3::Ident{},
                                 F1<T>{(const float*)b0, skip ? (const T*)x : nullptr, (T*)y0, Tlen, C}, part, st)));
  return tap3::reduce(part, s0, B * g.ntile, 2 * C, st);
}

template <typename T>
int f2(const void* y0, const void* mi0, const void* gb0, const void* w1, const void* b1, void* y1, float* part,
       float* s1, int B, int Tlen, int C, int d1, cudaStream_t st) {
  const tap3::Conv g = tap3::make_conv(B, Tlen, C, C, C, 0, d1, y0, w1);
  const float *mi = (const float*)mi0, *gb = (const float*)gb0;
  const tap3::BnGelu<T> pro{mi, gb, C};
  CHECK((tap3::launch_conv<T, 1>(y0, w1, g, pro, F2<T, tap3::BnGelu<T>>{(const float*)b1, (const T*)y0, pro, (T*)y1,
                                                                       Tlen, C}, part, st)));
  return tap3::reduce(part, s1, B * g.ntile, 2 * C, st);
}

template <typename T>
int f3(const void* y1, const void* mi1, const void* gb1, const void* w2, const void* b2, void* out, int B, int Tlen,
       int C, cudaStream_t st) {
  const tap3::Conv g = tap3::make_conv(B, Tlen, C, C, 2 * C, C, 2, y1, w2);
  return tap3::launch_conv<T, 2>(y1, w2, g, tap3::BnGelu<T>{(const float*)mi1, (const float*)gb1, C},
                                 F3<T>{(const float*)b2, (T*)out, Tlen, C}, nullptr, st);
}

template <typename T>
int b1(const void* dout, const void* y1, const void* mi1, const void* gb1, const void* w2, const void* b2,
       const void* w2t, void* h1, void* dy2, void* du1, float* part, float* db2, float* s, int B, int Tlen, int C,
       cudaStream_t st) {
  const float *mi = (const float*)mi1, *gb = (const float*)gb1;
  const tap3::Conv ga = tap3::make_conv(B, Tlen, C, C, 2 * C, C, 2, y1, w2);
  CHECK((tap3::launch_conv<T, 2>(y1, w2, ga, tap3::BnGelu<T>{mi, gb, C},
                                 B1a<T>{(const float*)b2, (const T*)dout, (T*)dy2, Tlen, C}, part, st, (T*)h1)));
  CHECK(tap3::reduce(part, db2, B * ga.ntile, 2 * C, st));
  const tap3::Conv gc = tap3::make_conv(B, Tlen, 2 * C, C, C, 0, 2, dy2, w2t);
  CHECK((tap3::launch_conv<T, 1>(dy2, w2t, gc, tap3::Ident{},
                                 GeluBnBwd<T>{nullptr, (const T*)y1, mi, gb, (T*)du1, Tlen, C}, part, st)));
  return tap3::reduce(part, s, B * gc.ntile, 2 * C, st);
}

template <typename T>
int b2(const void* du1, const void* y1, const void* mi1, const void* g1c, const void* y0, const void* mi0,
       const void* gb0, const void* w1t, void* dy1, void* h0, void* du0, float* part, float* db1, float* s, int B,
       int Tlen, int C, int d1, cudaStream_t st) {
  const int ntile = (Tlen + TM - 1) / TM;
  const float *mi0f = (const float*)mi0, *gb0f = (const float*)gb0;
  CHECK(bn_bwd<T>(BnBwd<T>{(const T*)du1, (const T*)y1, (const float*)mi1, (const float*)g1c, (T*)dy1,
                           (const T*)y0, mi0f, gb0f, (T*)h0, part, Tlen, C, ntile}, B, st));
  CHECK(tap3::reduce(part, db1, B * ntile, C, st));
  const tap3::Conv g = tap3::make_conv(B, Tlen, C, C, C, 0, d1, dy1, w1t);
  CHECK((tap3::launch_conv<T, 1>(dy1, w1t, g, tap3::Ident{},
                                 GeluBnBwd<T>{(const T*)dy1, (const T*)y0, mi0f, gb0f, (T*)du0, Tlen, C}, part, st)));
  return tap3::reduce(part, s, B * ntile, 2 * C, st);
}

template <typename T>
int b3(const void* du0, const void* y0, const void* mi0, const void* g0c, const void* w0t, void* dy0, void* dx,
       float* part, float* db0, int B, int Tlen, int Cin, int C, int d0, int skip, cudaStream_t st) {
  const int ntile = (Tlen + TM - 1) / TM;
  CHECK(bn_bwd<T>(BnBwd<T>{(const T*)du0, (const T*)y0, (const float*)mi0, (const float*)g0c, (T*)dy0,
                           nullptr, nullptr, nullptr, nullptr, part, Tlen, C, ntile}, B, st));
  CHECK(tap3::reduce(part, db0, B * ntile, C, st));
  const tap3::Conv g = tap3::make_conv(B, Tlen, C, Cin, Cin, 0, d0, dy0, w0t);
  return tap3::launch_conv<T, 1>(dy0, w0t, g, tap3::Ident{},
                                 B3c<T>{skip ? (const T*)dy0 : nullptr, (T*)dx, Tlen, Cin}, nullptr, st);
}

// K7's shared memory: the window of `out` (TM + 2 d0n rows of ldo elements,
// zero outside the recording and past C), the staging area of the conv tile
// (F3's input window and weights, then F1's weights), the tile's f32
// accumulators and the sums' exchange.
template <typename T>
struct F31Smem {
  using L3 = tap3::Layout<T, 2>;
  // bf16: rows of a multiple of 32 bytes keep wmma's fragment loads aligned
  __host__ __device__ static int ldo(int C) { return (C + 31) / 32 * 32 + (L3::TC ? 16 : 1); }
  __host__ __device__ static size_t win_bytes(int C, int d0n) {
    return ((size_t)(TM + 2 * d0n) * ldo(C) * sizeof(T) + 127) / 128 * 128;
  }
  __host__ __device__ static size_t bytes(int C, int d0n) {
    return win_bytes(C, d0n) + L3::stage_bytes(2) + (size_t)TM * L3::LDC * sizeof(float) + 4 * TN * sizeof(float);
  }
};

// Grid (ntile, B): one block owns times t0 + [0, TM) of recording b across
// all C channels. F3 runs over the window t0 - d0n + [0, TM + 2 d0n) in two
// TM-row passes, both GLU halves of every 64-channel tile, into shared
// memory (the tile's own rows also to `out`); then F1 of the next block runs
// its conv on that window, every output tile, with F1's epilogue.
template <typename T>
__global__ void __launch_bounds__(tap3::THREADS)
f31_kernel(const T* __restrict__ y1, const float* mi1, const float* gb1, const T* __restrict__ w2, const float* b2,
           const T* __restrict__ w0n, const float* b0n, T* out, T* y0n, float* __restrict__ part, tap3::Conv g3,
           tap3::Conv g1) {
  using L3 = tap3::Layout<T, 2>;
  using L1 = tap3::Layout<T, 1>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = g1.Cout, Tlen = g1.T, d0n = g1.d, W = TM + 2 * d0n, ldo = F31Smem<T>::ldo(C);
  T* win = reinterpret_cast<T*>(smem);
  unsigned char* stage = smem + F31Smem<T>::win_bytes(C, d0n);
  T* xs = reinterpret_cast<T*>(stage);
  T* ws = xs + L3::xs_elems(g3.d);
  float* cs = reinterpret_cast<float*>(stage + L3::stage_bytes(g3.d));
  float* red = cs + TM * L3::LDC;
  const int t0 = blockIdx.x * TM, b = blockIdx.y, tid = threadIdx.x, base = t0 - d0n;
  const int c = tid % TN, h = tid / TN;

  for (int i = tid; i < W * (ldo - C); i += tap3::THREADS)  // the last chunk of F1 reads past C
    win[(size_t)(i / (ldo - C)) * ldo + C + i % (ldo - C)] = from_f<T>(0.f);

  // F3 of block k into the window; rows outside [0, T) are zero, not
  // GLU(conv2(GELU(BN(0)))), as the split F1 reads them
  const tap3::BnGelu<T> pro{mi1, gb1, C};
  for (int r0 = base; r0 < t0 + TM + d0n; r0 += TM) {
    for (int n0 = 0; n0 < C; n0 += TN) {
      tap3::conv3_tile<T, 2>(xs, ws, cs, y1, w2, g3, pro, b, r0, n0, nullptr);
      const int co = n0 + c;
      if (co < C) {
        for (int r = h * (TM / 2); r < (h + 1) * (TM / 2) && r0 + r - base < W; ++r) {
          const int t = r0 + r;
          T v = from_f<T>(0.f);
          if (t >= 0 && t < Tlen) {
            v = F3<T>::glu(cs[(size_t)r * L3::LDC + c], cs[(size_t)r * L3::LDC + TN + c], b2, C, co);
            if (t >= t0 && t < t0 + TM) out[((size_t)b * Tlen + t) * C + co] = v;
          }
          win[(size_t)(t - base) * ldo + co] = v;
        }
      }
    }
  }

  // F1 of block k+1 from the window (its skip is `out`, read back from the
  // rows this block just wrote); per-block sums as the split F1 takes them
  const F1<T> epi{b0n, out, y0n, Tlen, C};
  for (int n0 = 0; n0 < C; n0 += TN) {
    tap3::Tile<T, 1> tile;
    tile.zero();
    for (int k0 = 0; k0 < C; k0 += L1::KC) {
      __syncthreads();  // the window is complete; everyone is done with the previous chunk
      tap3::load_weights<T, 1>(ws, w0n, g1, n0, k0);
      __syncthreads();
      tile.mma(win + k0, ldo, ws, d0n);
    }
    tile.store(cs);
    __syncthreads();
    const int co = n0 + c;
    float s0 = 0.f, s1 = 0.f;
    if (co < C) {
      for (int r = h * (TM / 2); r < (h + 1) * (TM / 2) && t0 + r < Tlen; ++r)
        epi(b, t0 + r, co, cs[(size_t)r * L1::LDC + c], 0.f, s0, s1);
    }
    red[(h * 2) * TN + c] = s0;
    red[(h * 2 + 1) * TN + c] = s1;
    __syncthreads();
    if (h == 0 && co < C) {
      float* p = part + (size_t)(b * g1.ntile + blockIdx.x) * 2 * C;
      p[co] = red[c] + red[2 * TN + c];
      p[C + co] = red[TN + c] + red[3 * TN + c];
    }
  }
}

template <typename T>
int f31(const void* y1, const void* mi1, const void* gb1, const void* w2, const void* b2, const void* w0n,
        const void* b0n, void* out, void* y0n, float* part, float* s0n, int B, int Tlen, int C, int d0n,
        cudaStream_t st) {
  const tap3::Conv g3 = tap3::make_conv(B, Tlen, C, C, 2 * C, C, 2, y1, w2);
  const tap3::Conv g1 = tap3::make_conv(B, Tlen, C, C, C, 0, d0n, out, w0n);
  const size_t smem = F31Smem<T>::bytes(C, d0n);
  if (smem > tap3::kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = f31_kernel<T>;
  CHECK((int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  if (C == 0) return (int)cudaSuccess;
  if (B > 0 && Tlen > 0) {
    kernel<<<dim3(g1.ntile, B), tap3::THREADS, smem, st>>>(
        (const T*)y1, (const float*)mi1, (const float*)gb1, (const T*)w2, (const float*)b2, (const T*)w0n,
        (const float*)b0n, (T*)out, (T*)y0n, part, g3, g1);
    CHECK((int)cudaGetLastError());
  }
  return tap3::reduce(part, s0n, B * g1.ntile, 2 * C, st);
}

// ---- the bf16 route: conv_wg (conv_wg.cuh) with K6's epilogues ------------------

// h = GELU(BN(y)) in bf16 (C % 8 == 0, bases 16-byte aligned): the conv
// input of F2 (h0), F3 and B1 (h1), with the values tap3's BnGelu prologue
// gives. Thread (g, r) takes channels 8g .. 8g + 7 of rows r, r + R, ...,
// 16 bytes a row, so it loads its channels' BatchNorm constants once.
__global__ void __launch_bounds__(256) bn_gelu_kernel(const bf16* __restrict__ y, const float* mi, const float* gb,
                                                      bf16* __restrict__ h, long long rows, int C, int* zero,
                                                      int nzero) {
  const int C8 = C / 8, per = blockDim.x / C8, g = threadIdx.x % C8, r0 = threadIdx.x / C8;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < nzero; i += blockDim.x) zero[i] = 0;
  tap3::BnConst k[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) k[q] = tap3::bn_const<bf16>(mi, gb, C, 8 * g + q);
  for (long long r = (long long)blockIdx.x * per + r0; r < rows; r += (long long)gridDim.x * per) {
    const size_t i = (size_t)r * C8 + g;
    const uint4 raw = reinterpret_cast<const uint4*>(y)[i];
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    uint4 out;
    bf16* o = reinterpret_cast<bf16*>(&out);
#pragma unroll
    for (int q = 0; q < 8; ++q) o[q] = from_f<bf16>(tap3::bn_gelu<bf16>(to_f(e[q]), k[q]));
    reinterpret_cast<uint4*>(h)[i] = out;
  }
}

// zero: nzero ints set to 0 on the way (K7's sync words, ahead of its walk)
int bn_gelu(const void* y, const void* mi, const void* gb, void* h, int B, int Tlen, int C, int sms,
            cudaStream_t st, int* zero = nullptr, int nzero = 0) {
  const long long rows = (long long)B * Tlen;
  const int C8 = C / 8;
  if (rows == 0 || C8 == 0) return (int)cudaSuccess;
  if (C8 > 256) return (int)cudaErrorInvalidValue;
  const int per = 256 / C8;
  const long long blocks = (rows + per - 1) / per;
  const int grid = (int)(blocks < 8LL * sms ? blocks : 8LL * sms);
  bn_gelu_kernel<<<grid, per * C8, 0, st>>>((const bf16*)y, (const float*)mi, (const float*)gb, (bf16*)h, rows, C,
                                            zero, nzero);
  return (int)cudaGetLastError();
}

// BnBwd for the bf16 route (C % 8 == 0, 16-byte-aligned tensors): block
// (tile, b) takes rows t0 .. t0 + 63 of recording b, as bn_bwd_kernel; thread
// (g, r) takes channels 8g .. 8g + 7 of rows t0 + r, t0 + r + per, ..., 16
// bytes a row, with the channels' constants loaded once. The sums of dy go
// through shared memory and are added in row-group order into the tile's
// slot of part, as bn_bwd_kernel's.
__global__ void __launch_bounds__(256) bn_bwd_wg_kernel(BnBwd<bf16> a) {
  __shared__ float red[256 * 8];
  const int C = a.C, C8 = C / 8, per = blockDim.x / C8, g = threadIdx.x % C8, r0 = threadIdx.x / C8;
  const int t0 = blockIdx.x * TM, b = blockIdx.y;
  float sum[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) sum[q] = 0.f;
  float m[8], inv[8], gc[8], c1[8], c2[8];
  tap3::BnConst kp[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int c = 8 * g + q;
    m[q] = a.mi[c]; inv[q] = a.mi[C + c];
    gc[q] = a.gc[c]; c1[q] = a.gc[C + c]; c2[q] = a.gc[2 * C + c];
    if (a.h) kp[q] = tap3::bn_const<bf16>(a.mip, a.gbp, C, c);
  }
  for (int r = r0; r < TM && t0 + r < a.T_; r += per) {
    const size_t i = ((size_t)b * a.T_ + t0 + r) * C8 + g;
    const uint4 du_raw = reinterpret_cast<const uint4*>(a.du)[i], y_raw = reinterpret_cast<const uint4*>(a.y)[i];
    const bf16 *du = reinterpret_cast<const bf16*>(&du_raw), *y = reinterpret_cast<const bf16*>(&y_raw);
    uint4 dy_raw;
    bf16* dy = reinterpret_cast<bf16*>(&dy_raw);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float xhat = (to_f(y[q]) - m[q]) * inv[q];
      dy[q] = from_f<bf16>(inv[q] * (gc[q] * to_f(du[q]) - c1[q] - xhat * c2[q]));
      sum[q] += to_f(dy[q]);
    }
    reinterpret_cast<uint4*>(a.dy)[i] = dy_raw;
    if (a.h) {
      const uint4 yp_raw = reinterpret_cast<const uint4*>(a.yp)[i];
      const bf16* yp = reinterpret_cast<const bf16*>(&yp_raw);
      uint4 h_raw;
      bf16* h = reinterpret_cast<bf16*>(&h_raw);
#pragma unroll
      for (int q = 0; q < 8; ++q) h[q] = from_f<bf16>(tap3::bn_gelu<bf16>(to_f(yp[q]), kp[q]));
      reinterpret_cast<uint4*>(a.h)[i] = h_raw;
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) red[threadIdx.x * 8 + q] = sum[q];
  __syncthreads();
  if (r0 == 0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float v = 0.f;
      for (int rr = 0; rr < per; ++rr) v += red[(rr * C8 + g) * 8 + q];
      a.part[((size_t)b * a.ntile + blockIdx.x) * C + 8 * g + q] = v;
    }
  }
}

int bn_bwd_wg(const BnBwd<bf16>& a, int B, cudaStream_t stream) {
  const int C8 = a.C / 8;
  if ((long long)B * a.T_ == 0 || C8 == 0) return (int)cudaSuccess;
  if (C8 > 256) return (int)cudaErrorInvalidValue;
  bn_bwd_wg_kernel<<<dim3(a.ntile, B), 256 / C8 * C8, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

int f1_wg(const void* xp, const void* w0k, const void* b0, void* y0, float* part, float* s0, int B, int Tlen,
          int cin_ld, int C, int d0, int skip, int sms, cudaStream_t st) {
  CHECK((conv_wg<1>(xp, cin_ld, w0k, F1<bf16>{(const float*)b0, skip ? (const bf16*)xp : nullptr, (bf16*)y0, Tlen, C},
                    part, B, Tlen, C, d0, sms, st)));
  return tap3::reduce(part, s0, B * wg::t_tiles(Tlen), 2 * C, st);
}

int f2_wg(const void* y0, const void* mi0, const void* gb0, const void* w1k, const void* b1, void* h0, void* y1,
          float* part, float* s1, int B, int Tlen, int C, int d1, int sms, cudaStream_t st) {
  CHECK(bn_gelu(y0, mi0, gb0, h0, B, Tlen, C, sms, st));
  CHECK((conv_wg<1>(h0, C, w1k, F2<bf16, tap3::Ident>{(const float*)b1, (const bf16*)h0, {}, (bf16*)y1, Tlen, C},
                    part, B, Tlen, C, d1, sms, st)));
  return tap3::reduce(part, s1, B * wg::t_tiles(Tlen), 2 * C, st);
}

int f3_wg(const void* y1, const void* mi1, const void* gb1, const void* w2g, const void* b2, void* h1, void* out,
          int B, int Tlen, int C, int sms, cudaStream_t st) {
  CHECK(bn_gelu(y1, mi1, gb1, h1, B, Tlen, C, sms, st));
  return conv_wg<2>(h1, C, w2g, F3<bf16>{(const float*)b2, (bf16*)out, Tlen, C}, nullptr, B, Tlen, C, 2, sms, st);
}

// ---- K7 on the bf16 route: F3's and F1's tiles in one persistent conv_wg walk ----

// K7's sync words, ints after its partials in the scratch (zeroed before
// every launch): the clock64 cycles producers spent waiting for F3 tiles
// (u64, 8-byte aligned), the claim counter, the number of waits, then per
// (recording, time tile) the F3 column tiles done
namespace f31s {
constexpr int CYCLES = 0, CLAIM = 2, WAITS = 3, READY = 4;
inline int words(int B, int t_tiles) { return READY + B * t_tiles; }
}  // namespace f31s

// the time tiles lo .. hi of `out` that F1's tile tt reads: rows tt TM - d0n
// .. (tt + 1) TM + d0n - 1 inside [0, T) (the tensor map reads the rest as
// zero, F1's 'SAME' padding); d0n <= 16 < TM, so at most tt - 1 .. tt + 1
__device__ __forceinline__ void f1_reads(int tt, int Tlen, int d0n, int& lo, int& hi) {
  lo = max(0, tt * wg::TM - d0n) / wg::TM;
  hi = (min(Tlen, (tt + 1) * wg::TM + d0n) - 1) / wg::TM;
}

// Tiles 0 .. n3 - 1 are F3's (co3 packed-column tiles of h1's GLU conv, then
// time tiles, then recordings, as f3_wg's conv_wg walks them), tiles n3 ..
// tiles - 1 F1's (co1 column tiles of the conv of `out` with w0n, likewise).
// Every product, epilogue and sum is f3_wg's or f1_wg's, so out, y0n and the
// partials are theirs bit for bit. What differs is the walk:
//   * The producer thread claims each tile from one counter of the launch
//     (not by blockIdx) and passes its index to the consumers with its first
//     stage. A block only ever waits for tiles claimed before its own, by
//     blocks that are running, so the walk needs no co-residency. Every F3
//     tile comes before every F1 tile, so F1 tiles all but never wait (an
//     interleave of recordings made them wait, and was slower: PERF.md).
//   * An F1 tile reads F3's `out` through TMA (the async proxy) after other
//     blocks wrote it with generic stores. Writer: the F3 tile's stores, a
//     barrier of the consumer warpgroups, then one thread's
//     fence.proxy.async.global and a release add to ready[b, tt]. Reader:
//     the producer polls ready[b, lo .. hi] with acquire loads until all co3
//     column tiles are done, fences the proxies, then loads. It blocks while
//     its own consumers may still run earlier tiles; that is safe because
//     the tile it waits for was claimed after every tile it depends on.
//   * F1's epilogue adds the skip, `out`, with generic loads: f1_wg's F1
//     reads it through ld.global.nc, undefined for data the same launch
//     writes, so here F1<bf16, true> reads it with plain loads, ordered after
//     F3's stores by each consumer thread's own acquire of ready[b, tt].
// Both epilogues (the GLU without sums, F1 with) live in one kernel under
// conv_wg's 416-thread, one-block-an-SM bounds, so its register cap; `nvcc
// -Xptxas -v` reports its spills (PERF.md). The four tensor maps (h1, glu_pack
// (w2), out, pack_weights(w0n)) have conv_wg's boxes, 192 x 64 and 160 x 64,
// and are __grid_constant__ parameters as in conv_wg_kernel. The sync words
// are zeroed by the BN·GELU pass ahead of every launch, so a second call on
// the same scratch gives the same bits.
__global__ void __launch_bounds__(wg::THREADS, 1)
f31_wg_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap w2map,
              const __grid_constant__ CUtensorMap omap, const __grid_constant__ CUtensorMap w0map,
              const F3<bf16> epi3, const F1<bf16, true> epi1, float* __restrict__ part, int* sync, int Tlen,
              int C, int d0n, int chunks, int co3, int co1, int t_tiles, int n3, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  const Ring r = ring_init(smem_raw);
  const int wg_ = threadIdx.x / 128;
  int* ready = sync + f31s::READY;
  if (wg_ == wg::CONSUMERS) {  // producer warp: one thread claims every tile and issues its loads
    if (threadIdx.x == wg::CONSUMERS * 128) {
      int k = 0, waits = 0;
      unsigned long long waited = 0;
      for (int tile = atomicAdd(sync + f31s::CLAIM, 1); tile < tiles; tile = atomicAdd(sync + f31s::CLAIM, 1)) {
        if (tile < n3) {
          load_tile(r, &hmap, &w2map, tile % co3 * wg::TN, tile / co3 % t_tiles * wg::TM, tile / (co3 * t_tiles), 2,
                    chunks, k, tile);
          continue;
        }
        const int f = tile - n3, tt = f / co1 % t_tiles, b = f / (co1 * t_tiles);
        int lo, hi;
        f1_reads(tt, Tlen, d0n, lo, hi);
        for (int q = lo; q <= hi; ++q) {
          const int* done = ready + b * t_tiles + q;
          if (hopper::ld_acquire(done) >= co3) continue;
          const long long start = clock64();
          while (hopper::ld_acquire(done) < co3) {
            if (clock64() - start > (1LL << 35)) __trap();  // a fault, not a wait: do not hold the card
            __nanosleep(64);
          }
          waited += clock64() - start;
          ++waits;
        }
        hopper::fence_proxy_async_global();
        load_tile(r, &omap, &w0map, f % co1 * wg::TN, tt * wg::TM, b, d0n, chunks, k, tile);
      }
      // the end: one stage without loads whose index -1 stops the consumers
      const int st = k % wg::STAGES;
      if (k >= wg::STAGES) hopper::mbar_wait(&r.empty[st], (k / wg::STAGES - 1) & 1);
      r.tile[st] = -1;
      hopper::mbar_arrive(&r.full[st]);
      if (waits) {
        atomicAdd(reinterpret_cast<unsigned long long*>(sync + f31s::CYCLES), waited);
        atomicAdd(sync + f31s::WAITS, waits);
      }
    }
    return;
  }

  const int w = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  float acc[wg::TN / 2];
  int k = 0, it = 0;
  for (;;) {
    const int st = k % wg::STAGES;
    hopper::mbar_wait(&r.full[st], (k / wg::STAGES) & 1);  // mma_tile's first wait then passes at once
    const int tile = r.tile[st];
    if (tile < 0) break;
    mma_tile(r, acc, 3 * chunks, wg_, lane, k);
    if (tile < n3) {
      const int tt = tile / co3 % t_tiles, b = tile / (co3 * t_tiles);
      store_tile<2>(epi3, acc, nullptr, nullptr, wg_, w, lane, tile % co3 * wg::TN, tt, b, Tlen, C, t_tiles);
      consumers_sync();  // every store of `out` in this tile is made
      if (threadIdx.x == 0) {
        hopper::fence_proxy_async_global();
        hopper::red_release_add(ready + b * t_tiles + tt, 1);
      }
    } else {
      const int f = tile - n3, tt = f / co1 % t_tiles, b = f / (co1 * t_tiles);
      hopper::ld_acquire(ready + b * t_tiles + tt);  // already co3 (the producer waited): orders the skip's loads
      store_tile<1>(epi1, acc, r.red + (it++ & 1) * wg::RED, part, wg_, w, lane, f % co1 * wg::TN, tt, b, Tlen, C,
                    t_tiles);
    }
  }
}

// K7's wgmma route: h1 = BN·GELU(y1) (the pass f3_wg runs), the merged walk,
// then the reduction of F1's partials (f1_wg's); sync: f31s::words ints,
// 8-byte aligned
int f31_wg(const void* y1, const void* mi1, const void* gb1, const void* w2g, const void* b2, const void* w0k,
           const void* b0n, void* h1, void* out, void* y0n, float* part, int* sync, float* s0n, int B, int Tlen,
           int C, int d0n, int sms, cudaStream_t st) {
  const int t_tiles = wg::t_tiles(Tlen);
  if ((long long)B * Tlen > 0 && C > 0) {
    CUtensorMap hmap, w2map, omap, w0map;
    if ((uintptr_t)sync % 8 != 0 || !hopper::make_map_bf16(&hmap, h1, C, Tlen, B, wg::TM) ||
        !hopper::make_map_bf16(&w2map, w2g, C, 2 * C, 3, wg::TN) ||
        !hopper::make_map_bf16(&omap, out, C, Tlen, B, wg::TM) ||
        !hopper::make_map_bf16(&w0map, w0k, C, C, 3, wg::TN))
      return (int)cudaErrorInvalidValue;
    const int co3 = (2 * C + wg::TN - 1) / wg::TN, co1 = (C + wg::TN - 1) / wg::TN;
    const long long n3 = (long long)co3 * t_tiles * B, tiles = n3 + (long long)co1 * t_tiles * B;
    if (tiles + sms > 0x7fffffff) return (int)cudaErrorInvalidValue;  // every producer claims once past the end
    CHECK(bn_gelu(y1, mi1, gb1, h1, B, Tlen, C, sms, st, sync, f31s::words(B, t_tiles)));
    CHECK((int)cudaFuncSetAttribute(f31_wg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)wg::SMEM));
    const int grid = (int)(tiles < sms ? tiles : sms);
    f31_wg_kernel<<<grid, wg::THREADS, wg::SMEM, st>>>(
        hmap, w2map, omap, w0map, F3<bf16>{(const float*)b2, (bf16*)out, Tlen, C},
        F1<bf16, true>{(const float*)b0n, (const bf16*)out, (bf16*)y0n, Tlen, C}, part, sync, Tlen, C, d0n,
        (C + 63) / 64, co3, co1, t_tiles, (int)n3, (int)tiles);
    CHECK((int)cudaGetLastError());
  }
  return tap3::reduce(part, s0n, B * t_tiles, 2 * C, st);
}

int b1_wg(const void* dout, const void* y1, const void* mi1, const void* gb1, const void* w2g, const void* b2,
          const void* w2tk, void* h1, void* dy2, void* du1, float* part, float* db2, float* s, int B, int Tlen, int C,
          int sms, cudaStream_t st) {
  const float *mi = (const float*)mi1, *gb = (const float*)gb1;
  const int np = B * wg::t_tiles(Tlen);
  CHECK(bn_gelu(y1, mi, gb, h1, B, Tlen, C, sms, st));
  CHECK((conv_wg<2>(h1, C, w2g, B1a<bf16>{(const float*)b2, (const bf16*)dout, (bf16*)dy2, Tlen, C}, part, B, Tlen,
                    C, 2, sms, st)));
  CHECK(tap3::reduce(part, db2, np, 2 * C, st));
  CHECK((conv_wg<1>(dy2, 2 * C, w2tk, GeluBnBwd<bf16>{nullptr, (const bf16*)y1, mi, gb, (bf16*)du1, Tlen, C}, part,
                    B, Tlen, C, 2, sms, st)));
  return tap3::reduce(part, s, np, 2 * C, st);
}

int b2_wg(const void* du1, const void* y1, const void* mi1, const void* g1c, const void* y0, const void* mi0,
          const void* gb0, const void* w1tk, void* dy1, void* h0, void* du0, float* part, float* db1, float* s, int B,
          int Tlen, int C, int d1, int sms, cudaStream_t st) {
  const int ntile = (Tlen + TM - 1) / TM;  // the BN-backward pass's 64-row tiles
  const float *mi0f = (const float*)mi0, *gb0f = (const float*)gb0;
  CHECK(bn_bwd_wg(BnBwd<bf16>{(const bf16*)du1, (const bf16*)y1, (const float*)mi1, (const float*)g1c, (bf16*)dy1,
                              (const bf16*)y0, mi0f, gb0f, (bf16*)h0, part, Tlen, C, ntile}, B, st));
  CHECK(tap3::reduce(part, db1, B * ntile, C, st));
  CHECK((conv_wg<1>(dy1, C, w1tk,
                    GeluBnBwd<bf16>{(const bf16*)dy1, (const bf16*)y0, mi0f, gb0f, (bf16*)du0, Tlen, C}, part, B,
                    Tlen, C, d1, sms, st)));
  return tap3::reduce(part, s, B * wg::t_tiles(Tlen), 2 * C, st);
}

int b3_wg(const void* du0, const void* y0, const void* mi0, const void* g0c, const void* w0tk, void* dy0, void* dx,
          float* part, float* db0, int B, int Tlen, int Cin, int C, int d0, int skip, int sms, cudaStream_t st) {
  const int ntile = (Tlen + TM - 1) / TM;
  CHECK(bn_bwd_wg(BnBwd<bf16>{(const bf16*)du0, (const bf16*)y0, (const float*)mi0, (const float*)g0c, (bf16*)dy0,
                              nullptr, nullptr, nullptr, nullptr, part, Tlen, C, ntile}, B, st));
  CHECK(tap3::reduce(part, db0, B * ntile, C, st));
  // dx has Cin channels (270 at block 0): packed rows past Cin read as zero, columns past Cin are not stored
  return conv_wg<1>(dy0, C, w0tk, B3c<bf16>{skip ? (const bf16*)dy0 : nullptr, (bf16*)dx, Tlen, Cin}, nullptr, B,
                    Tlen, Cin, d0, sms, st);
}

}  // namespace

// Shapes: x (B, T, Cin); y0, y1, out, du1, du0, dy1, dy0, h0, h1, y0n (B, T, C);
// dy2 (B, T, 2C); w0 (3, Cin, C), w1 (3, C, C), w2 (3, C, 2C) and the
// transposed w0t (3, C, Cin), w1t (3, C, C), w2t (3, 2C, C), all in dt; b0,
// b1 (C,), b2 (2C,), mi/gb (2, C) [mean; inv] / [scale; bias], g1c/g0c (3, C)
// [g; c1; c2] f32; sums s0, s1, s, s0n (2, C), db2 (2C,), db1, db0 (C,) f32;
// K7 (cbt_f31) takes block k+1's w0n (3, C, C) in dt, b0n (C,) f32 and d0n.
#define ENTRIES(SUF, T)                                                                                          \
  extern "C" int cbt_f1_##SUF(const void* x, const void* w0, const void* b0, void* y0, void* part, void* s0,      \
                              int B, int Tlen, int Cin, int C, int d0, int skip, void* st) {                     \
    return f1<T>(x, w0, b0, y0, (float*)part, (float*)s0, B, Tlen, Cin, C, d0, skip, (cudaStream_t)st);          \
  }                                                                                                              \
  extern "C" int cbt_f2_##SUF(const void* y0, const void* mi0, const void* gb0, const void* w1, const void* b1,   \
                              void* y1, void* part, void* s1, int B, int Tlen, int C, int d1, void* st) {         \
    return f2<T>(y0, mi0, gb0, w1, b1, y1, (float*)part, (float*)s1, B, Tlen, C, d1, (cudaStream_t)st);          \
  }                                                                                                              \
  extern "C" int cbt_f3_##SUF(const void* y1, const void* mi1, const void* gb1, const void* w2, const void* b2,   \
                              void* out, int B, int Tlen, int C, void* st) {                                     \
    return f3<T>(y1, mi1, gb1, w2, b2, out, B, Tlen, C, (cudaStream_t)st);                                       \
  }                                                                                                              \
  extern "C" int cbt_b1_##SUF(const void* dout, const void* y1, const void* mi1, const void* gb1, const void* w2, \
                              const void* b2, const void* w2t, void* h1, void* dy2, void* du1, void* part,        \
                              void* db2, void* s, int B, int Tlen, int C, void* st) {                             \
    return b1<T>(dout, y1, mi1, gb1, w2, b2, w2t, h1, dy2, du1, (float*)part, (float*)db2, (float*)s, B, Tlen,    \
                 C, (cudaStream_t)st);                                                                           \
  }                                                                                                              \
  extern "C" int cbt_b2_##SUF(const void* du1, const void* y1, const void* mi1, const void* g1c, const void* y0,  \
                              const void* mi0, const void* gb0, const void* w1t, void* dy1, void* h0, void* du0,  \
                              void* part, void* db1, void* s, int B, int Tlen, int C, int d1, void* st) {         \
    return b2<T>(du1, y1, mi1, g1c, y0, mi0, gb0, w1t, dy1, h0, du0, (float*)part, (float*)db1, (float*)s, B,     \
                 Tlen, C, d1, (cudaStream_t)st);                                                                 \
  }                                                                                                              \
  extern "C" int cbt_b3_##SUF(const void* du0, const void* y0, const void* mi0, const void* g0c, const void* w0t, \
                              void* dy0, void* dx, void* part, void* db0, int B, int Tlen, int Cin, int C, int d0, \
                              int skip, void* st) {                                                              \
    return b3<T>(du0, y0, mi0, g0c, w0t, dy0, dx, (float*)part, (float*)db0, B, Tlen, Cin, C, d0, skip,         \
                 (cudaStream_t)st);                                                                              \
  }                                                                                                              \
  extern "C" int cbt_f31_##SUF(const void* y1, const void* mi1, const void* gb1, const void* w2, const void* b2,  \
                               const void* w0n, const void* b0n, void* out, void* y0n, void* part, void* s0n,     \
                               int B, int Tlen, int C, int d0n, void* st) {                                      \
    return f31<T>(y1, mi1, gb1, w2, b2, w0n, b0n, out, y0n, (float*)part, (float*)s0n, B, Tlen, C, d0n,         \
                  (cudaStream_t)st);                                                                             \
  }

ENTRIES(f32, float)
ENTRIES(bf16, bf16)

// The bf16 route on wgmma (csrc/conv_wg.cuh). Every conv input and packed
// weight 16-byte aligned, C % 8 == 0, y0 and y1 16-byte aligned (the BN·GELU
// pass reads them 16 bytes at a time). xp (B, T, cin_ld): x with its
// channels zero-padded to cin_ld; K-major weights (wk[j, n, ci] = W_j[ci,
// n]): w0k (3, C, cin_ld), w1k (3, C, C), w2g (3, 2C, C) with channel c's
// value and gate columns at n = 2c and 2c + 1, w2tk (3, C, 2C), w1tk (3, C,
// C) and w0tk (3, Cin, C) those of the transposed convs; h0 and h1 (B, T, C)
// the BN·GELU pass's output (F2's and F3's scratch, B1's h1 for K2); sms:
// the card's SM count. Other arguments as the tap3 entries'.
extern "C" int cbt_f1_wg(const void* xp, const void* w0k, const void* b0, void* y0, void* part, void* s0, int B,
                         int Tlen, int cin_ld, int C, int d0, int skip, int sms, void* st) {
  return f1_wg(xp, w0k, b0, y0, (float*)part, (float*)s0, B, Tlen, cin_ld, C, d0, skip, sms, (cudaStream_t)st);
}
extern "C" int cbt_f2_wg(const void* y0, const void* mi0, const void* gb0, const void* w1k, const void* b1, void* h0,
                         void* y1, void* part, void* s1, int B, int Tlen, int C, int d1, int sms, void* st) {
  return f2_wg(y0, mi0, gb0, w1k, b1, h0, y1, (float*)part, (float*)s1, B, Tlen, C, d1, sms, (cudaStream_t)st);
}
extern "C" int cbt_f3_wg(const void* y1, const void* mi1, const void* gb1, const void* w2g, const void* b2, void* h1,
                         void* out, int B, int Tlen, int C, int sms, void* st) {
  return f3_wg(y1, mi1, gb1, w2g, b2, h1, out, B, Tlen, C, sms, (cudaStream_t)st);
}
// K7's wgmma route (C % 8 == 0, y1 16-byte aligned): w2g glu_pack(w2) (3,
// 2C, C), w0k pack_weights(w0n) (3, C, C); h1 (B, T, C) scratch; part f32
// scratch of B * ceil(T / 192) * 2 * C, sync the ints after it
extern "C" int cbt_f31_wg(const void* y1, const void* mi1, const void* gb1, const void* w2g, const void* b2,
                          const void* w0k, const void* b0n, void* h1, void* out, void* y0n, void* part, void* sync,
                          void* s0n, int B, int Tlen, int C, int d0n, int sms, void* st) {
  return f31_wg(y1, mi1, gb1, w2g, b2, w0k, b0n, h1, out, y0n, (float*)part, (int*)sync, (float*)s0n, B, Tlen, C, d0n,
                sms, (cudaStream_t)st);
}
extern "C" int cbt_b1_wg(const void* dout, const void* y1, const void* mi1, const void* gb1, const void* w2g,
                         const void* b2, const void* w2tk, void* h1, void* dy2, void* du1, void* part, void* db2,
                         void* s, int B, int Tlen, int C, int sms, void* st) {
  return b1_wg(dout, y1, mi1, gb1, w2g, b2, w2tk, h1, dy2, du1, (float*)part, (float*)db2, (float*)s, B, Tlen, C, sms,
               (cudaStream_t)st);
}
extern "C" int cbt_b2_wg(const void* du1, const void* y1, const void* mi1, const void* g1c, const void* y0,
                         const void* mi0, const void* gb0, const void* w1tk, void* dy1, void* h0, void* du0, void* part,
                         void* db1, void* s, int B, int Tlen, int C, int d1, int sms, void* st) {
  return b2_wg(du1, y1, mi1, g1c, y0, mi0, gb0, w1tk, dy1, h0, du0, (float*)part, (float*)db1, (float*)s, B, Tlen, C,
               d1, sms, (cudaStream_t)st);
}
extern "C" int cbt_b3_wg(const void* du0, const void* y0, const void* mi0, const void* g0c, const void* w0tk,
                         void* dy0, void* dx, void* part, void* db0, int B, int Tlen, int Cin, int C, int d0, int skip,
                         int sms, void* st) {
  return b3_wg(du0, y0, mi0, g0c, w0tk, dy0, dx, (float*)part, (float*)db0, B, Tlen, Cin, C, d0, skip, sms,
               (cudaStream_t)st);
}
