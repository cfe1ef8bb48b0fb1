// Direction-batched RNN recurrence under an element-wise activation act,
// forward and backward, fp32, for Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_rnn_fwd_call` and
// `_rnn_bwd_call` (the pair behind `rnn_recurrence`, whose act is tanh)
// and the JAX package's lax.scan of an RnnCell with any other element-wise
// activation.  Contract over the hoisted input projection zx (T, D, B, H)
// (both biases added) and the recurrent weights wht (D, H, H), D
// directions, from the initial state h0 (D, B, H) or zeros (the JAX
// kernel starts from zeros; h0 carries a truncated run's state from one
// chunk to the next):
//   pre = zx[t,d] + h . wht[d],  h' = act(pre)    -> hs[t,d]
// and the backward in reverse time from dh = 0:
//   dz  = (gout[t] + dh) act'(pre_t)              -> dzx[t]
//   dh  = dz . wht[d]^T
//   dwht[d] = sum_t hprev^T . dz            (recurrence_dwh.cuh; hprev is
//                                            h0 or zeros at t = 0)
// act is one of the twenty kinds of `act_fwd` (ops/_activation.py lists
// them in order of their codes), with up to three parameters; its
// derivative is the JAX package's, kinks included (a clip's bound takes
// 1/2, abs at 0 takes 1).  tanh's derivative is 1 - h^2, from the stored
// h stack, with no recompute; every other kind's is a function of pre,
// which a parallel pre-pass recomputes for every step at once (a tiled
// product over the h stack read at t - 1, h0 at t = 0, into dzx, which
// the loop overwrites unit by unit).  tanhf, expf, ...: no fast math.
//
// What bounds it on this card: at SimpleRNN's width (T 8, B 4, H 40) a
// call is a few microseconds of work and the launch and the serial chain
// of T dependent steps set its time; at (500, 2, 128, 128) the products
// are 4.2 GFLOP each way (0.06 ms at the fp32 peak) against ~0.1 GB moved,
// and again the chain of T steps, each needing the previous step's h,
// sets the time.
//
// What this design does about it: the cluster recurrence of
// recurrence_cluster.cuh.  One cluster of C blocks per (direction, tile
// of R batch rows) walks all T steps; block k owns hidden units [k H /
// C, (k + 1) H / C), holds its columns of wht[d] (forward) or its rows
// (backward: dh[u] = sum_j dz[j] wht[u, j] needs row u, so no transpose
// launch) in shared memory for all T steps when they fit, and sends its
// new h (dz) slice to every block of the cluster through distributed
// shared memory before the step's one cluster barrier.  Each lane
// prefetches its own zx (gout and h_t or pre_t) values several steps
// ahead into a cp.async ring, so no step waits on device memory.  The
// activation is a launch argument, switched on in each update (the same
// kind in every lane): one instantiation a plan for the nineteen kinds
// other than tanh, and tanh's own, whose switch cost 6-9% of the RNN's
// time at (500, 2, 128, 128) (recurrence_ab.py).
// The plan (C, R) is a function of (D, B, H) (ops/_recurrence.py mirrors
// it): C = 1 at SimpleRNN's width, where one block's barrier is cheaper
// than a cluster's.  The product sums runs of 32 terms from zero, then
// runs of those: at H = 14,528 one fp32 chain of H roundings leaves h
// about ten times further from the exact sum than the blocked plain
// version.

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

}  // namespace

extern "C" {

// Forward over zx (T, D, B, H) and wht (D, H, H) from h0 (D, B, H), or
// zeros when h0 is null, under activation `act` (a kind code) with
// parameters a, b, c: hs (T, D, B, H), under the plan of the shape (C = R
// = 0) or at (C, R).  One launch.  Returns the cudaError_t of the launch.
int bigdl_rnn_fwd_f32(const float* zx, const float* wht, const float* h0,
                      float* hs, int T, int D, int B, int H, int C, int R,
                      int act, float a, float b, float c, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  const Args args{{zx}, wht, h0, nullptr, hs, nullptr, dm};
  const Plan p = plan_of<RnnFwd<true>>(D, B, H, C, R);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return act == kTanhAct
             ? (int)launch_planned<RnnFwd<true>>(args, p, st)
             : (int)launch_planned<RnnFwd<false>>(args, p, st,
                                                  Act{act, a, b, c});
}

// Backward: dzx (T, D, B, H) from wht, the forward's hs and the cotangent
// gout (T, D, B, H) under activation `act`, under the plan as the
// forward's.  tanh: one launch, zx and h0 unread.  Any other kind: two
// launches on the stream, the pre-activations of every step from zx, the
// h stack and h0 (or zeros when null) into dzx, then the serial loop.
int bigdl_rnn_bwd_f32(const float* zx, const float* wht, const float* hs,
                      const float* h0, const float* gout, float* dzx, int T,
                      int D, int B, int H, int C, int R, int act, float a,
                      float b, float c, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  const Plan p = plan_of<RnnBwd<true>>(D, B, H, C, R);
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
             ? (int)launch_planned<RnnBwd<true>>(args, p, st)
             : (int)launch_planned<RnnBwd<false>>(args, p, st,
                                                  Act{act, a, b, c});
}

// The plan of the forward (bwd = 0) or backward (1) at (D, B, H) into
// out[8]: C, R, RT, KP, S, staged, depth, bytes (C = 0: none fits).
void bigdl_rnn_plan(int bwd, int D, int B, int H, int* out) {
  plan_out(bwd ? plan_of<RnnBwd<true>>(D, B, H)
               : plan_of<RnnFwd<true>>(D, B, H),
           out);
}

// dwht (D, H, H) = sum over t, b of hprev^T . dzx, hprev the h stack at
// t - 1 and h0 (or zeros when null) at t = 0, in S slices of `slice`
// rows (recurrence_dwh.cuh); `part` is scratch of S * D * H * H floats.
// Two launches.
int bigdl_rnn_dwh_f32(const float* hs, const float* h0, const float* dzx,
                      float* part, float* dwht, int T, int D, int B, int H,
                      int S, long long slice, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const DwhShape sh{T, D, B, H, H, slice};
  return (int)launch_dwh(Stack{hs, h0, true}, dzx, part, dwht, sh, S,
                         static_cast<cudaStream_t>(stream));
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
