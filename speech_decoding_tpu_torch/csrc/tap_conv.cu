// K5: the dilated k=3 'SAME' conv in one launch,
//   y[b, t] = sum_j x[b, t + (j - 1) d] @ W_j,  j = 0, 1, 2,
// rows of x outside [0, T) read as zero, f32 accumulation, one cast to x's
// dtype at the output.
//
// Replaces the Pallas TPU kernel speech_decoding_tpu/ops/pallas/tap_conv.py
// (_tap_conv_kernel through tap_conv). The Pallas kernel keeps two whole
// recordings and the (3, Cin, Cout) weights in VMEM and adds the three tap
// products shifted. Here the conv tile of tap3.cuh (time tiles with a halo
// of d, weights streamed through shared memory in 32-channel chunks) does the
// same sum; the backward's dx is this kernel on the tap-reversed, transposed
// weights, and dW is K2 (tap_conv_dw.cu).
//
// What bounds it on an H100: operations. The flagship's 320 -> 320 conv at
// B = 64, T = 360 is 14.2 GFLOP (14 us at 989 TFLOP/s in bf16) against
// ~30 MB of x, W and y (9 us at 3.35 TB/s). x and y cross device memory once
// each; the weights are read once per time tile, from L2.
//
// C interface (ctypes): pointers and the stream as void*, returns the
// cudaGetLastError() of the launch (or of the shared-memory attribute call).

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

template <typename T>
int run(const void* x, const void* w, void* y, int B, int Tlen, int Cin, int Cout, int d, void* stream) {
  const tap3::Conv g = tap3::make_conv(B, Tlen, Cin, Cout, Cout, 0, d, x, w);
  return tap3::launch_conv<T, 1>(x, w, g, tap3::Ident{}, Store<T>{(T*)y, Tlen, Cout}, nullptr,
                                 (cudaStream_t)stream);
}

}  // namespace

// x (B, T, Cin), w (3, Cin, Cout), y (B, T, Cout), one dtype; 0 < d
extern "C" int tap_conv_f32(const void* x, const void* w, void* y, int B, int Tlen, int Cin, int Cout, int d,
                            void* stream) {
  return run<float>(x, w, y, B, Tlen, Cin, Cout, d, stream);
}

extern "C" int tap_conv_bf16(const void* x, const void* w, void* y, int B, int Tlen, int Cin, int Cout, int d,
                             void* stream) {
  return run<tap3::bf16>(x, w, y, B, Tlen, Cin, Cout, d, stream);
}
