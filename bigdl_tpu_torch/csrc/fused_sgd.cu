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
// Nesterov is a template flag; lr, momentum, weight decay and dampening
// are launch arguments, so a scheduled lr costs nothing.
//
// What bounds it on this card: bytes.  Each parameter reads p, g, v and
// writes p, v: 20 bytes for about 6 flops, far below the H100's fp32
// ridge (67 TFLOP/s over 3.35 TB/s, about 20 flops per byte).  The least
// time is 20 bytes per parameter over the memory rate.
//
// What this design does about it:
//  - one launch per step over all leaves (the JAX package launches once
//    per leaf): a device table holds (p, g, v, n, first chunk, vec) per
//    leaf, and each block takes one fixed-size chunk of one leaf, found by
//    a binary search over the leaves' first chunks;
//  - p and v are updated in place, each byte read once and written once;
//  - 16-byte loads and stores (neighbouring threads on neighbouring
//    addresses) when the leaf's three pointers are 16-byte aligned, with
//    a scalar tail for a leaf whose size is not a multiple of 4;
//  - `finite` (a device bool, or null): a block that reads false returns
//    before any write, so a step with non-finite gradients leaves p and v
//    as they were, without a host sync.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Leaf {  // one row of the int64 table the wrapper uploads
  long long p, g, v, n, first_chunk, vec;
};

template <bool NESTEROV>
__device__ __forceinline__ void update(float& p, float g, float& v, float lr,
                                       float mom, float wd, float damp,
                                       bool has_mom) {
  g = g + wd * p;
  if (has_mom) {
    v = mom * v + (1.0f - damp) * g;
    p = p - lr * (NESTEROV ? g + mom * v : v);
  } else {
    p = p - lr * g;
  }
}

template <bool NESTEROV>
__global__ void __launch_bounds__(kThreads)
    fused_sgd_kernel(const Leaf* __restrict__ leaves, int n_leaves, int chunk,
                     float lr, float mom, float wd, float damp,
                     const unsigned char* __restrict__ finite) {
  if (finite != nullptr && *finite == 0) return;
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
  const bool has_mom = mom != 0.0f;
  int done = 0;
  if (leaf.vec) {
    const int n4 = len >> 2;
    float4* P4 = reinterpret_cast<float4*>(P);
    const float4* G4 = reinterpret_cast<const float4*>(G);
    float4* V4 = reinterpret_cast<float4*>(V);
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float4 p = P4[i];
      const float4 g = G4[i];
      float4 v = has_mom ? V4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      update<NESTEROV>(p.x, g.x, v.x, lr, mom, wd, damp, has_mom);
      update<NESTEROV>(p.y, g.y, v.y, lr, mom, wd, damp, has_mom);
      update<NESTEROV>(p.z, g.z, v.z, lr, mom, wd, damp, has_mom);
      update<NESTEROV>(p.w, g.w, v.w, lr, mom, wd, damp, has_mom);
      P4[i] = p;
      if (has_mom) V4[i] = v;
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads) {
    float p = P[i];
    float v = has_mom ? V[i] : 0.0f;
    update<NESTEROV>(p, G[i], v, lr, mom, wd, damp, has_mom);
    P[i] = p;
    if (has_mom) V[i] = v;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` of `device` over `n_chunks` chunks of `chunk`
// elements (a multiple of 4); `table` is the device copy of n_leaves rows
// of (p, g, v, n, first chunk, vec) int64.  Returns the cudaError_t of the
// launch (0 on success).
int bigdl_fused_sgd_f32(const long long* table, int n_leaves, int n_chunks,
                        int chunk, float lr, float mom, float wd, float damp,
                        int nesterov, const unsigned char* finite, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Leaf* leaves = reinterpret_cast<const Leaf*>(table);
  if (nesterov)
    fused_sgd_kernel<true><<<n_chunks, kThreads, 0, st>>>(
        leaves, n_leaves, chunk, lr, mom, wd, damp, finite);
  else
    fused_sgd_kernel<false><<<n_chunks, kThreads, 0, st>>>(
        leaves, n_leaves, chunk, lr, mom, wd, damp, finite);
  return (int)cudaGetLastError();
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
