// Cross-channel local response normalisation (LRN), fp32, for Hopper
// (sm_90a).
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_lrn_fwd_kernel`,
// `_lrn_fwd_res_kernel` and `_lrn_bwd_kernel` (the trio behind
// `lrn_channel`).  Contract, as there, over NCHW x with lo = (size-1)/2,
// hi = size-1-lo and channels outside [0, C) read as 0:
//   z  = k + (alpha/size) * sum_{s=0..size-1} x[c-lo+s]^2
//   y  = x / z^beta             (z^0.75 as sqrt(sqrt(z))^3, `_lrn_pow`;
//                                powf for any other beta)
//   forward: y only (no gradient needed), or y and z (fp32), the only
//            residual besides x;
//   backward from the stored z, one adjoint window sum (pads (hi, lo)):
//   u  = g * x / (z^beta * z)
//   dx = g / z^beta - (2 alpha beta/size) * x * sum_{s=0..size-1} u[c-hi+s]
// Every window sum runs tap by tap in the JAX order (s = 0 .. size-1),
// never as a running sum that subtracts the tap leaving the window (that
// cancels catastrophically when a large square leaves).  Each product,
// sum and quotient is rounded on its own (__fmul_rn and friends: no FMA
// contraction), as the plain version in ops/lrn.py rounds them.
//
// What bounds it on this card: bytes.  The forward reads x and writes y
// (and z); the backward reads x, z and g and writes dx; each element costs
// a few flops and two square roots, far below the fp32 ridge.
//
// What this design does about it: one thread per (n, h*w) column walks
// a run of up to 32 channels, so at every channel a warp's loads and
// stores are 32 neighbouring h*w positions (coalesced, NCHW as it is: no
// transpose).  At size 5 (Inception's) the last five squares (backward:
// the last five u, g/z^beta and x) sit in a register window shifted by one
// each channel, so a run re-reads only the size-1 channels of its window
// that lie outside it (L2 hits, a neighbouring run reads them); any other
// size takes a generic loop that re-reads its taps (L1 hits after the
// first).  Cutting the channels into runs gives C/32 times the threads:
// enough blocks to fill the card evenly (Inception's 128 x 56 x 56
// columns alone make 1.5 waves).  The TPU kernel's (C, 3200-lane) VMEM
// blocks exist for its lanes and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 32;  // channels a thread walks

__device__ __forceinline__ float lrn_pow(float z, float beta, bool sqrt_pow) {
  if (sqrt_pow) {  // beta == 0.75: two square roots, no exp/log
    const float zb = __fsqrt_rn(__fsqrt_rn(z));
    return __fmul_rn(__fmul_rn(zb, zb), zb);
  }
  return powf(z, beta);
}

struct LrnArgs {
  int C, HW, size;
  long long tiles;  // column tiles of kThreads per sample
  int runs;         // runs of kRun channels per column
  float scale;      // alpha / size
  float k, beta;
  float c2;  // 2 alpha beta / size
  bool sqrt_pow;
};

// This thread's sample base offset plus column, and its run of channels
// [c0, c1); false past the last column.  Blocks go column tile fastest,
// then run, then sample.
__device__ __forceinline__ bool column(const LrnArgs& a, long long* base,
                                       int* c0, int* c1) {
  const long long b = blockIdx.x / a.tiles;
  const int p = (int)(blockIdx.x % a.tiles) * kThreads + threadIdx.x;
  const long long n = b / a.runs;
  *c0 = (int)(b % a.runs) * kRun;
  *c1 = min(*c0 + kRun, a.C);
  *base = n * a.C * a.HW + p;
  return p < a.HW;
}

__device__ __forceinline__ float ld(const float* __restrict__ t,
                                    long long base, int ch, const LrnArgs& a) {
  return (ch >= 0 && ch < a.C) ? t[base + (long long)ch * a.HW] : 0.0f;
}

// SIZE > 0: the register window of SIZE taps; SIZE == 0: any a.size.
template <int SIZE, bool WITH_Z>
__global__ void __launch_bounds__(kThreads)
    lrn_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                   float* __restrict__ z, LrnArgs a) {
  long long base;
  int c0, c1;
  if (!column(a, &base, &c0, &c1)) return;
  const int lo = (a.size - 1) / 2;
  float xw[SIZE > 0 ? SIZE : 1], sq[SIZE > 0 ? SIZE : 1];
  if constexpr (SIZE > 0) {
    // window slot t holds channel c - lo + t; start one channel before c0
#pragma unroll
    for (int t = 0; t < SIZE; ++t) {
      const float v = ld(x, base, c0 + t - lo - 1, a);
      xw[t] = v;
      sq[t] = __fmul_rn(v, v);
    }
  }
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    float acc, xc;
    if constexpr (SIZE > 0) {
#pragma unroll
      for (int t = 0; t + 1 < SIZE; ++t) {
        xw[t] = xw[t + 1];
        sq[t] = sq[t + 1];
      }
      const float v = ld(x, base, c + SIZE - 1 - lo, a);
      xw[SIZE - 1] = v;
      sq[SIZE - 1] = __fmul_rn(v, v);
      acc = sq[0];
#pragma unroll
      for (int t = 1; t < SIZE; ++t) acc = __fadd_rn(acc, sq[t]);
      xc = xw[(SIZE - 1) / 2];
    } else {
      float v = ld(x, base, c - lo, a);
      acc = __fmul_rn(v, v);
      for (int s = 1; s < a.size; ++s) {
        v = ld(x, base, c - lo + s, a);
        acc = __fadd_rn(acc, __fmul_rn(v, v));
      }
      xc = ld(x, base, c, a);
    }
    const float zz = __fadd_rn(a.k, __fmul_rn(a.scale, acc));
    const long long o = base + (long long)c * a.HW;
    y[o] = __fdiv_rn(xc, lrn_pow(zz, a.beta, a.sqrt_pow));
    if (WITH_Z) z[o] = zz;
  }
}

// the backward's per-channel terms: u = g x / (z^b z) and g / z^b
__device__ __forceinline__ void bwd_terms(const float* __restrict__ x,
                                          const float* __restrict__ z,
                                          const float* __restrict__ g,
                                          long long base, int ch,
                                          const LrnArgs& a, float* u,
                                          float* gz, float* xv) {
  if (ch < 0 || ch >= a.C) {
    *u = 0.0f;
    *gz = 0.0f;
    *xv = 0.0f;
    return;
  }
  const long long o = base + (long long)ch * a.HW;
  const float xx = x[o], zz = z[o], gg = g[o];
  const float zp = lrn_pow(zz, a.beta, a.sqrt_pow);
  *u = __fdiv_rn(__fmul_rn(gg, xx), __fmul_rn(zp, zz));
  *gz = __fdiv_rn(gg, zp);
  *xv = xx;
}

template <int SIZE>
__global__ void __launch_bounds__(kThreads)
    lrn_bwd_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ g, float* __restrict__ dx,
                   LrnArgs a) {
  long long base;
  int c0, c1;
  if (!column(a, &base, &c0, &c1)) return;
  // the adjoint window: channel c takes u over c - hi .. c + lo
  const int hi = a.size - 1 - (a.size - 1) / 2;
  float uw[SIZE > 0 ? SIZE : 1], gw[SIZE > 0 ? SIZE : 1],
      xw[SIZE > 0 ? SIZE : 1];
  if constexpr (SIZE > 0) {
    // window slot t holds channel c - hi + t; start one channel before c0
#pragma unroll
    for (int t = 0; t < SIZE; ++t)
      bwd_terms(x, z, g, base, c0 + t - hi - 1, a, &uw[t], &gw[t], &xw[t]);
  }
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    float S, gc, xc;
    if constexpr (SIZE > 0) {
#pragma unroll
      for (int t = 0; t + 1 < SIZE; ++t) {
        uw[t] = uw[t + 1];
        gw[t] = gw[t + 1];
        xw[t] = xw[t + 1];
      }
      bwd_terms(x, z, g, base, c + SIZE - 1 - hi, a, &uw[SIZE - 1],
                &gw[SIZE - 1], &xw[SIZE - 1]);
      S = uw[0];
#pragma unroll
      for (int t = 1; t < SIZE; ++t) S = __fadd_rn(S, uw[t]);
      const int at = SIZE - 1 - (SIZE - 1) / 2;  // slot of channel c: hi
      gc = gw[at];
      xc = xw[at];
    } else {
      float u, gz, xv;
      bwd_terms(x, z, g, base, c - hi, a, &S, &gz, &xv);
      for (int s = 1; s < a.size; ++s) {
        bwd_terms(x, z, g, base, c - hi + s, a, &u, &gz, &xv);
        S = __fadd_rn(S, u);
      }
      bwd_terms(x, z, g, base, c, a, &u, &gc, &xc);
    }
    dx[base + (long long)c * a.HW] =
        __fsub_rn(gc, __fmul_rn(__fmul_rn(a.c2, xc), S));
  }
}

LrnArgs make_args(int C, int HW, int size, double alpha, double beta,
                  double k) {
  LrnArgs a;
  a.C = C;
  a.HW = HW;
  a.size = size;
  a.tiles = (HW + kThreads - 1) / kThreads;
  a.runs = (C + kRun - 1) / kRun;
  // the JAX kernel's scalars: Python doubles rounded once to fp32
  a.scale = (float)(alpha / size);
  a.k = (float)k;
  a.beta = (float)beta;
  a.c2 = (float)(2.0 * alpha * beta / size);
  a.sqrt_pow = beta == 0.75;
  return a;
}

}  // namespace

extern "C" {

// Forward over x (N, C, H*W); `z` null takes the primal variant that
// writes no residual.  Returns the cudaError_t of the launch.
int bigdl_lrn_fwd_f32(const float* x, float* y, float* z, long long N, int C,
                      int HW, int size, double alpha, double beta, double k,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || C == 0 || HW == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LrnArgs a = make_args(C, HW, size, alpha, beta, k);
  const long long blocks = N * a.runs * a.tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  if (size == 5) {
    if (z != nullptr)
      lrn_fwd_kernel<5, true><<<grid, kThreads, 0, st>>>(x, y, z, a);
    else
      lrn_fwd_kernel<5, false><<<grid, kThreads, 0, st>>>(x, y, nullptr, a);
  } else {
    if (z != nullptr)
      lrn_fwd_kernel<0, true><<<grid, kThreads, 0, st>>>(x, y, z, a);
    else
      lrn_fwd_kernel<0, false><<<grid, kThreads, 0, st>>>(x, y, nullptr, a);
  }
  return (int)cudaGetLastError();
}

// Backward: dx (N, C, H*W) from x, the stored z and the cotangent g.
int bigdl_lrn_bwd_f32(const float* x, const float* z, const float* g,
                      float* dx, long long N, int C, int HW, int size,
                      double alpha, double beta, double k, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || C == 0 || HW == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const LrnArgs a = make_args(C, HW, size, alpha, beta, k);
  const long long blocks = N * a.runs * a.tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  if (size == 5)
    lrn_bwd_kernel<5><<<grid, kThreads, 0, st>>>(x, z, g, dx, a);
  else
    lrn_bwd_kernel<0><<<grid, kThreads, 0, st>>>(x, z, g, dx, a);
  return (int)cudaGetLastError();
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
