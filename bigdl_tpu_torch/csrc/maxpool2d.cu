// NCHW max pooling, forward and backward, fp32, for Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_mosaic_mp_fwd_kernel`,
// `_mosaic_mp_fwd_kernel_primal` and `_mosaic_mp_bwd_kernel` (the Mosaic
// pair behind `mosaic_maxpool2d`).  Contract, as there:
//   forward  x (N, C, H, W) -> y (N, C, OH, OW) and, when a gradient is
//            needed, the int32 window argmax i * kw + j of each output;
//            any window, stride and explicit pads (lo_h, lo_w; the high
//            pads only set OH and OW); padded taps read as -inf; taps are
//            walked in row-major order with a strict >, so the FIRST max
//            wins a tie (XLA select_and_scatter's rule), a NaN at the
//            window's first tap is kept and a NaN at a later tap never
//            wins;
//   backward (argmax, g) -> dx (N, C, H, W): each input element sums
//            g[oh, ow] over the outputs whose window covers it and whose
//            stored argmax names it.  A gather: no atomics, no scatter.
//
// What bounds it on this card: bytes.  The forward reads x and writes y
// and the argmax, the backward reads g and the argmax and writes dx, with
// one compare (or one add) per tap: far below the fp32 ridge.
//
// What this design does about it: one thread per output element
// (forward) or per input element (backward), neighbouring threads on
// neighbouring W positions, so loads and stores of a warp are contiguous
// (strided by the pool stride on the forward's reads).  Overlapping
// windows re-read x from L1/L2, not from device memory.  The TPU
// kernel's phase-folded NHWC frame and row blocking exist for its lanes
// and VMEM and are not carried over: NCHW stays as it is, with no
// transpose or padding pass.

#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

template <bool WITH_ARGMAX>
__global__ void __launch_bounds__(kThreads)
    maxpool2d_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                         int* __restrict__ argmax, long long total, int H,
                         int W, int OH, int OW, int kh, int kw, int sh, int sw,
                         int plh, int plw) {
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  const int ow = (int)(o % OW);
  const long long t = o / OW;
  const int oh = (int)(t % OH);
  const long long nc = t / OH;
  const float* xp = x + nc * H * W;
  const int h0 = oh * sh - plh, w0 = ow * sw - plw;
  float best = -CUDART_INF_F;
  int arg = 0;
  for (int i = 0; i < kh; ++i) {
    const int ih = h0 + i;
    const bool row_in = ih >= 0 && ih < H;
    for (int j = 0; j < kw; ++j) {
      const int iw = w0 + j;
      const float v =
          (row_in && iw >= 0 && iw < W) ? xp[ih * W + iw] : -CUDART_INF_F;
      if ((i == 0 && j == 0) || v > best) {  // strict >: first max wins
        best = v;
        arg = i * kw + j;
      }
    }
  }
  y[o] = best;
  if (WITH_ARGMAX) argmax[o] = arg;
}

__global__ void __launch_bounds__(kThreads)
    maxpool2d_bwd_kernel(const float* __restrict__ g,
                         const int* __restrict__ argmax, float* __restrict__ dx,
                         long long total, int H, int W, int OH, int OW, int kh,
                         int kw, int sh, int sw, int plh, int plw) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int iw = (int)(e % W);
  const long long t = e / W;
  const int ih = (int)(t % H);
  const long long nc = t / H;
  // this element in the padded frame, and the outputs whose window holds
  // it: oh * sh <= ph <= oh * sh + kh - 1
  const int ph = ih + plh, pw = iw + plw;
  const int oh_lo = ph < kh ? 0 : (ph - kh + sh) / sh;
  const int oh_hi = min(ph / sh, OH - 1);
  const int ow_lo = pw < kw ? 0 : (pw - kw + sw) / sw;
  const int ow_hi = min(pw / sw, OW - 1);
  const long long base = nc * OH * OW;
  float acc = 0.0f;
  for (int oh = oh_lo; oh <= oh_hi; ++oh) {
    const int i = ph - oh * sh;
    for (int ow = ow_lo; ow <= ow_hi; ++ow) {
      const long long o = base + (long long)oh * OW + ow;
      if (argmax[o] == i * kw + (pw - ow * sw)) acc += g[o];
    }
  }
  dx[e] = acc;
}

unsigned grid_for(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Forward over NC = N * C planes; `argmax` null takes the primal variant
// that writes no argmax.  Returns the cudaError_t of the launch.
int bigdl_maxpool2d_fwd_f32(const float* x, float* y, int* argmax, long long NC,
                            int H, int W, int OH, int OW, int kh, int kw, int sh,
                            int sw, int plh, int plw, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = NC * OH * OW;
  if (argmax != nullptr)
    maxpool2d_fwd_kernel<true><<<grid_for(total), kThreads, 0, st>>>(
        x, y, argmax, total, H, W, OH, OW, kh, kw, sh, sw, plh, plw);
  else
    maxpool2d_fwd_kernel<false><<<grid_for(total), kThreads, 0, st>>>(
        x, y, nullptr, total, H, W, OH, OW, kh, kw, sh, sw, plh, plw);
  return (int)cudaGetLastError();
}

// Backward: dx (NC, H, W) from the cotangent g and the argmax (NC, OH, OW).
int bigdl_maxpool2d_bwd_f32(const float* g, const int* argmax, float* dx,
                            long long NC, int H, int W, int OH, int OW, int kh,
                            int kw, int sh, int sw, int plh, int plw,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = NC * H * W;
  maxpool2d_bwd_kernel<<<grid_for(total), kThreads, 0, st>>>(
      g, argmax, dx, total, H, W, OH, OW, kh, kw, sh, sw, plh, plw);
  return (int)cudaGetLastError();
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
