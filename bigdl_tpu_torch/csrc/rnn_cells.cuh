// The RNN cells of rnn.cu's kernels (the f32 form and the bf16-weight
// form, rnn.cu's header says what they compute and how) and the bodies of
// their entries, shared by rnn.cu (the f32 form, the plans and the weight
// gradient) and rnn_bf16.cu (the bf16-weight form).  The two forms are two
// libraries so that nvcc builds them in parallel: one source of both took
// 122 s to build against 56 s before the bf16 form, on the host of an
// H100 machine (the slowest library sets the smoke's build time).
#pragma once

#include "recurrence_cluster.cuh"
#include "recurrence_dwh.cuh"

namespace {

// the kinds' codes, in the order of ops/_activation.py KINDS
enum ActKind {
  kTanhAct, kRelu, kRelu6, kTanhShrink, kSigmoidAct, kLogSigmoid, kSoftPlus,
  kSoftSign, kSoftShrink, kHardShrink, kHardTanh, kThreshold, kLeakyRelu,
  kElu, kAbs, kSqrt, kSquare, kPower, kExp, kLog
};

// the JAX package's softplus: logaddexp(y, 0)
__device__ __forceinline__ float softplus(float y) {
  return fmaxf(y, 0.0f) + log1pf(expf(-fabsf(y)));
}

// act(x), bigdl_tpu/nn/activations.py's expression of each kind; a, b, c
// are LeakyReLU's negval, ELU's alpha, SoftPlus's beta, HardTanh's bounds,
// Threshold's th and v, a shrink's lambda, Power's power, scale and shift
__device__ __forceinline__ float act_fwd(const Act& f, float x) {
  switch (f.kind) {
    case kTanhAct: return tanhf(x);
    case kRelu: return x < 0.0f ? 0.0f : x;
    case kRelu6: return x < 0.0f ? 0.0f : (x > 6.0f ? 6.0f : x);
    case kTanhShrink: return x - tanhf(x);
    case kSigmoidAct: return sigm(x);
    case kLogSigmoid: return -softplus(-x);
    case kSoftPlus: return softplus(f.a * x) / f.a;
    case kSoftSign: return x / (1.0f + fabsf(x));
    case kSoftShrink: return x > f.a ? x - f.a : (x < -f.a ? x + f.a : 0.0f);
    case kHardShrink: return fabsf(x) > f.a ? x : 0.0f;
    case kHardTanh: return x < f.a ? f.a : (x > f.b ? f.b : x);
    case kThreshold: return x > f.a ? x : f.b;
    case kLeakyRelu: return x >= 0.0f ? x : x * f.a;
    case kElu: return x > 0.0f ? x : f.a * (expf(x) - 1.0f);
    case kAbs: return fabsf(x);
    case kSqrt: return sqrtf(x);
    case kSquare: return x * x;
    case kPower: return powf(f.c + f.b * x, f.a);
    case kExp: return expf(x);
    case kLog: return logf(x);
  }
  return x;
}

// a clip's derivative, the JAX one: 1/2 at a bound (a max or min of a tie)
__device__ __forceinline__ float clip_grad(float p, float lo, float hi) {
  return (p == lo || p == hi) ? 0.5f : (p > lo && p < hi ? 1.0f : 0.0f);
}

// act'(p) at the pre-activation p of every kind but tanh (whose backward
// reads h), the JAX derivative: abs at 0 takes 1
__device__ __forceinline__ float act_grad(const Act& f, float p) {
  switch (f.kind) {
    case kRelu: return p > 0.0f ? 1.0f : 0.0f;
    case kRelu6: return clip_grad(p, 0.0f, 6.0f);
    case kTanhShrink: { const float t = tanhf(p); return t * t; }
    case kSigmoidAct: { const float s = sigm(p); return s * (1.0f - s); }
    case kLogSigmoid: return sigm(-p);
    case kSoftPlus: return sigm(f.a * p);
    case kSoftSign: { const float d = 1.0f + fabsf(p); return 1.0f / (d * d); }
    case kSoftShrink: return (p > f.a || p < -f.a) ? 1.0f : 0.0f;
    case kHardShrink: return fabsf(p) > f.a ? 1.0f : 0.0f;
    case kHardTanh: return clip_grad(p, f.a, f.b);
    case kThreshold: return p > f.a ? 1.0f : 0.0f;
    case kLeakyRelu: return p >= 0.0f ? 1.0f : f.a;
    case kElu: return p > 0.0f ? 1.0f : f.a * expf(p);
    case kAbs: return p >= 0.0f ? 1.0f : -1.0f;
    case kSqrt: return 0.5f / sqrtf(p);
    case kSquare: return 2.0f * p;
    case kPower:
      return f.a == 0.0f ? 0.0f : f.b * f.a * powf(f.c + f.b * p, f.a - 1.0f);
    case kExp: return expf(p);
    case kLog: return 1.0f / p;
  }
  return 1.0f;
}

// h' = act(zx + h . wht[d]); TANH: tanh, with no switch (one
// instantiation for tanh, one for the other kinds)
template <bool TANH>
struct RnnFwd {
  static constexpr int G = 1, V = 1, E = 1;
  static constexpr bool kReverse = false, kHasC = false, kWeightT = false,
                        kAct = true;
  __host__ __device__ static constexpr In input(int) { return {0, 0, 1, 0}; }
  __device__ static void update(const Act& f, const float* x, const float* z,
                                float&, float* y) {
    y[0] = TANH ? tanhf(x[0] + z[0]) : act_fwd(f, x[0] + z[0]);
  }
};

// dz = (gout + dz' . wht[d]^T) act'(pre), in reverse time; x = (gout, h)
// for tanh (act' = 1 - h^2), else (gout, pre)
template <bool TANH>
struct RnnBwd {
  static constexpr int G = 1, V = 1, E = 2;
  static constexpr bool kReverse = true, kHasC = false, kWeightT = true,
                        kAct = true;
  __host__ __device__ static constexpr In input(int q) { return {q, 0, 1, 0}; }
  __device__ static void update(const Act& f, const float* x, const float* z,
                                float&, float* y) {
    if constexpr (TANH) {
      y[0] = (x[0] + z[0]) * (1.0f - x[1] * x[1]);
    } else {
      y[0] = (x[0] + z[0]) * act_grad(f, x[1]);
    }
  }
};

// the bf16-weight form: the same cells on a bf16 wht; zx and the stacks
// stay f32
template <bool TANH>
struct RnnFwdBf16 : RnnFwd<TANH> {
  using WT = __nv_bfloat16;
};
template <bool TANH>
struct RnnBwdBf16 : RnnBwd<TANH> {
  using WT = __nv_bfloat16;
};

// The forward of cells `Fwd<TANH>` over wht of WT: one launch.
template <template <bool> class Fwd, class WT>
int rnn_fwd(const float* zx, const WT* wht, const float* h0, float* hs,
            int T, int D, int B, int H, int C, int R, int act, float a,
            float b, float c, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  const Args args{{zx}, wht, h0, nullptr, hs, nullptr, dm};
  const Plan p = plan_of<Fwd<true>>(D, B, H, C, R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return act == kTanhAct
             ? (int)launch_planned<Fwd<true>>(args, p, st)
             : (int)launch_planned<Fwd<false>>(args, p, st,
                                              Act{act, a, b, c});
}

// The backward of cells `Bwd<TANH>` over wht of WT: tanh one launch; any
// other kind the pre-pass (on the same WT weight) into dzx, then the
// serial loop.
template <template <bool> class Bwd, class WT>
int rnn_bwd(const float* zx, const WT* wht, const float* hs,
            const float* h0, const float* gout, float* dzx, int T, int D,
            int B, int H, int C, int R, int act, float a, float b, float c,
            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  const Plan p = plan_of<Bwd<true>>(D, B, H, C, R);
  if (p.C == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = hs;
  if (act != kTanhAct) {
    launch_prepass<kIdentity, false>(zx, wht, Stack{hs, h0, true}, dzx,
                                     nullptr, DwhShape{T, D, B, H, H, 0}, st);
    v = dzx;
  }
  const Args args{{gout, v}, wht, nullptr, nullptr, dzx, nullptr, dm};
  return act == kTanhAct
             ? (int)launch_planned<Bwd<true>>(args, p, st)
             : (int)launch_planned<Bwd<false>>(args, p, st,
                                               Act{act, a, b, c});
}

using bf16 = __nv_bfloat16;

}  // namespace
