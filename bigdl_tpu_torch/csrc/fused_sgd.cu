// Momentum SGD over every parameter of a model in one launch, fp32, for
// Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_make_sgd_kernel` and
// `_fused_sgd_flat` (the Pallas pass behind `fused_sgd`, reached through
// `SGD(fused=True)`).  Math, per element, as there:
//   g~ = g + wd * p
//   momentum != 0:  v' = mom * v + (1 - damp) * g~
//                   p' = p - lr * (nesterov ? g~ + mom * v' : v')
//   momentum == 0:  v untouched, p' = p - lr * g~ (dampening ignored)
// With per-parameter learning rates (the JAX `SGD.update` with
// `lr_scales`, :125-131, the reference's `learningRates`), the step
// direction d (v', g~ + mom * v', or g~) is multiplied by the parameter's
// scale s before the rate: p' = p - lr * (d * s); the velocity is not
// scaled.  A leaf's scale pointer is 0 in the unscaled form.
// Nesterov is a template flag; lr, momentum, weight decay and dampening
// are launch arguments, so a scheduled lr costs nothing.  lr may instead
// be read from a one-float device tensor (`lr_dev`, non-null): a CUDA
// graph that captures the launch then takes the lr written there before
// each replay, where a host argument would stay the value at capture.
// Both forms use the same fp32 value the same way, so they give the same
// bits.
//
// What bounds it on this card: bytes.  Each parameter reads p, g, v and
// writes p, v: 20 bytes for about 6 flops, far below the H100's fp32
// ridge (67 TFLOP/s over 3.35 TB/s, about 20 flops per byte).  The least
// time is 20 bytes per parameter over the memory rate, 24 in the scaled
// form (s is read too).
//
// What this design does about it:
//  - one launch per step over all leaves (the JAX package launches once
//    per leaf): a device table holds (p, g, v, n, first chunk, vec) per
//    leaf, and each block takes one fixed-size chunk of one leaf, found by
//    a binary search over the leaves' first chunks; the scaled form is a
//    template flag, so the unscaled form reads no scale and keeps its
//    code;
//  - p and v are updated in place, each byte read once and written once;
//  - 16-byte loads and stores (neighbouring threads on neighbouring
//    addresses) when the leaf's pointers (the scale's too) are 16-byte
//    aligned, with
//    a scalar tail for a leaf whose size is not a multiple of 4;
//  - `finite` (a device bool, or null): a block that reads false returns
//    before any write, so a step with non-finite gradients leaves p and v
//    as they were, without a host sync.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Leaf {  // one row of the int64 table the wrapper uploads
  long long p, g, v, s, n, first_chunk, vec;
};

template <bool NESTEROV, bool SCALED>
__device__ __forceinline__ void update(float& p, float g, float& v, float s,
                                       float lr, float mom, float wd,
                                       float damp, bool has_mom) {
  g = g + wd * p;
  float d = g;
  if (has_mom) {
    v = mom * v + (1.0f - damp) * g;
    d = NESTEROV ? g + mom * v : v;
  }
  if (SCALED) d = d * s;
  p = p - lr * d;
}

template <bool NESTEROV, bool SCALED>
__global__ void __launch_bounds__(kThreads)
    fused_sgd_kernel(const Leaf* __restrict__ leaves, int n_leaves, int chunk,
                     float lr_arg, const float* __restrict__ lr_dev,
                     float mom, float wd, float damp,
                     const unsigned char* __restrict__ finite) {
  if (finite != nullptr && *finite == 0) return;
  const float lr = lr_dev != nullptr ? *lr_dev : lr_arg;
  // the last leaf whose first chunk is <= this block
  const long long c = blockIdx.x;
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].first_chunk <= c) lo = mid; else hi = mid - 1;
  }
  const Leaf leaf = leaves[lo];
  const long long start = (c - leaf.first_chunk) * chunk;
  const long long rest = leaf.n - start;
  const int len = rest < chunk ? (int)rest : chunk;
  float* P = reinterpret_cast<float*>(leaf.p) + start;
  const float* G = reinterpret_cast<const float*>(leaf.g) + start;
  float* V = reinterpret_cast<float*>(leaf.v) + start;
  const float* S = SCALED ? reinterpret_cast<const float*>(leaf.s) + start
                          : nullptr;
  const bool has_mom = mom != 0.0f;
  int done = 0;
  if (leaf.vec) {
    const int n4 = len >> 2;
    float4* P4 = reinterpret_cast<float4*>(P);
    const float4* G4 = reinterpret_cast<const float4*>(G);
    float4* V4 = reinterpret_cast<float4*>(V);
    const float4* S4 = reinterpret_cast<const float4*>(S);
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float4 p = P4[i];
      const float4 g = G4[i];
      float4 v = has_mom ? V4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 s = SCALED ? S4[i] : make_float4(1.f, 1.f, 1.f, 1.f);
      update<NESTEROV, SCALED>(p.x, g.x, v.x, s.x, lr, mom, wd, damp,
                               has_mom);
      update<NESTEROV, SCALED>(p.y, g.y, v.y, s.y, lr, mom, wd, damp,
                               has_mom);
      update<NESTEROV, SCALED>(p.z, g.z, v.z, s.z, lr, mom, wd, damp,
                               has_mom);
      update<NESTEROV, SCALED>(p.w, g.w, v.w, s.w, lr, mom, wd, damp,
                               has_mom);
      P4[i] = p;
      if (has_mom) V4[i] = v;
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads) {
    float p = P[i];
    float v = has_mom ? V[i] : 0.0f;
    update<NESTEROV, SCALED>(p, G[i], v, SCALED ? S[i] : 1.0f, lr, mom, wd,
                             damp, has_mom);
    P[i] = p;
    if (has_mom) V[i] = v;
  }
}

template <bool NESTEROV, bool SCALED>
void launch(const Leaf* leaves, int n_leaves, int n_chunks, int chunk,
            float lr, const float* lr_dev, float mom, float wd, float damp,
            const unsigned char* finite, cudaStream_t st) {
  fused_sgd_kernel<NESTEROV, SCALED><<<n_chunks, kThreads, 0, st>>>(
      leaves, n_leaves, chunk, lr, lr_dev, mom, wd, damp, finite);
}

}  // namespace

extern "C" {

// Launch on `stream` of `device` over `n_chunks` chunks of `chunk`
// elements (a multiple of 4); `table` is the device copy of n_leaves rows
// of (p, g, v, s, n, first chunk, vec) int64; lr is `*lr_dev` where that
// is non-null, else `lr`; `scaled` (every leaf's s non-null) selects the
// per-parameter-rate form.  Returns the cudaError_t of the launch (0 on
// success).
int bigdl_fused_sgd_f32(const long long* table, int n_leaves, int n_chunks,
                        int chunk, float lr, const float* lr_dev, float mom,
                        float wd, float damp, int nesterov, int scaled,
                        const unsigned char* finite, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Leaf* leaves = reinterpret_cast<const Leaf*>(table);
  if (nesterov && scaled)
    launch<true, true>(leaves, n_leaves, n_chunks, chunk, lr, lr_dev, mom,
                       wd, damp, finite, st);
  else if (nesterov)
    launch<true, false>(leaves, n_leaves, n_chunks, chunk, lr, lr_dev, mom,
                        wd, damp, finite, st);
  else if (scaled)
    launch<false, true>(leaves, n_leaves, n_chunks, chunk, lr, lr_dev, mom,
                        wd, damp, finite, st);
  else
    launch<false, false>(leaves, n_leaves, n_chunks, chunk, lr, lr_dev, mom,
                         wd, damp, finite, st);
  return (int)cudaGetLastError();
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
