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
//
// The taps form (a template flag, `taps` non-null: the JAX package's
// `obs/taps.py` `compute`, "a single fused pass over tensors the backward
// already has") adds, while each element's p, g and p' sit in registers,
// four sums into `taps` (float64): sum p^2, sum (p' - p)^2, sum g^2 (the
// raw gradient, before weight decay) and the count of non-finite g.  Each
// thread sums its elements in fp32, the block reduces them (warp shuffles,
// then one shared row a warp), and thread 0 adds the block's four partials
// with four float64 atomics.  p' and v' come from the same `update` as the
// form without taps, so their bits are the same.  On a step whose `finite`
// reads false the block still reads and sums (its p' is p: the update
// ratio reads 0, as the JAX step's skip-select gives) and writes nothing
// but the sums.  The form reads the same 20 bytes a parameter (24 scaled)
// and adds 32 bytes of atomics a block: its bound is the form without
// taps'.

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

// the taps form's per-thread sums: p^2, (p' - p)^2, g^2, non-finite g
struct Sums {
  float p2 = 0.f, d2 = 0.f, g2 = 0.f, bad = 0.f;
};

template <bool TAPS>
__device__ __forceinline__ void tap(Sums& t, float p0, float p1, float g,
                                    bool write) {
  if (!TAPS) return;
  t.p2 += p0 * p0;
  t.g2 += g * g;
  t.bad += isfinite(g) ? 0.f : 1.f;
  if (write) {
    const float d = p1 - p0;
    t.d2 += d * d;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// the block's four sums into taps[0..3] (order: g2, p2, d2, bad)
__device__ __forceinline__ void block_taps(Sums t, double* taps) {
  __shared__ float part[kThreads / 32][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  t.g2 = warp_sum(t.g2);
  t.p2 = warp_sum(t.p2);
  t.d2 = warp_sum(t.d2);
  t.bad = warp_sum(t.bad);
  if (lane == 0) {
    part[warp][0] = t.g2;
    part[warp][1] = t.p2;
    part[warp][2] = t.d2;
    part[warp][3] = t.bad;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += part[w][threadIdx.x];
    atomicAdd(taps + threadIdx.x, (double)s);
  }
}

template <bool NESTEROV, bool SCALED, bool TAPS>
__global__ void __launch_bounds__(kThreads)
    fused_sgd_kernel(const Leaf* __restrict__ leaves, int n_leaves, int chunk,
                     float lr_arg, const float* __restrict__ lr_dev,
                     float mom, float wd, float damp,
                     const unsigned char* __restrict__ finite,
                     double* __restrict__ taps) {
  const bool write = finite == nullptr || *finite != 0;
  if (!TAPS && !write) return;
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
  Sums t;
  int done = 0;
  if (leaf.vec) {
    const int n4 = len >> 2;
    float4* P4 = reinterpret_cast<float4*>(P);
    const float4* G4 = reinterpret_cast<const float4*>(G);
    float4* V4 = reinterpret_cast<float4*>(V);
    const float4* S4 = reinterpret_cast<const float4*>(S);
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      const float4 p0 = P4[i];
      float4 p = p0;
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
      tap<TAPS>(t, p0.x, p.x, g.x, write);
      tap<TAPS>(t, p0.y, p.y, g.y, write);
      tap<TAPS>(t, p0.z, p.z, g.z, write);
      tap<TAPS>(t, p0.w, p.w, g.w, write);
      if (write) {
        P4[i] = p;
        if (has_mom) V4[i] = v;
      }
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < len; i += kThreads) {
    const float p0 = P[i];
    const float g = G[i];
    float p = p0;
    float v = has_mom ? V[i] : 0.0f;
    update<NESTEROV, SCALED>(p, g, v, SCALED ? S[i] : 1.0f, lr, mom, wd,
                             damp, has_mom);
    tap<TAPS>(t, p0, p, g, write);
    if (write) {
      P[i] = p;
      if (has_mom) V[i] = v;
    }
  }
  if (TAPS) block_taps(t, taps);
}

template <bool NESTEROV, bool SCALED, bool TAPS>
void launch(const Leaf* leaves, int n_leaves, int n_chunks, int chunk,
            float lr, const float* lr_dev, float mom, float wd, float damp,
            const unsigned char* finite, double* taps, cudaStream_t st) {
  fused_sgd_kernel<NESTEROV, SCALED, TAPS><<<n_chunks, kThreads, 0, st>>>(
      leaves, n_leaves, chunk, lr, lr_dev, mom, wd, damp, finite, taps);
}

template <bool NESTEROV, bool SCALED>
void launch_taps(const Leaf* leaves, int n_leaves, int n_chunks, int chunk,
                 float lr, const float* lr_dev, float mom, float wd,
                 float damp, const unsigned char* finite, double* taps,
                 cudaStream_t st) {
  if (taps != nullptr)
    launch<NESTEROV, SCALED, true>(leaves, n_leaves, n_chunks, chunk, lr,
                                   lr_dev, mom, wd, damp, finite, taps, st);
  else
    launch<NESTEROV, SCALED, false>(leaves, n_leaves, n_chunks, chunk, lr,
                                    lr_dev, mom, wd, damp, finite, taps, st);
}

}  // namespace

extern "C" {

// Launch on `stream` of `device` over `n_chunks` chunks of `chunk`
// elements (a multiple of 4); `table` is the device copy of n_leaves rows
// of (p, g, v, s, n, first chunk, vec) int64; lr is `*lr_dev` where that
// is non-null, else `lr`; `scaled` (every leaf's s non-null) selects the
// per-parameter-rate form; a non-null `taps` (4 float64 on the device)
// selects the taps form, which adds the step's sums g^2, p^2, (p' - p)^2
// and non-finite g into it.  Returns the cudaError_t of the launch (0 on
// success).
int bigdl_fused_sgd_f32(const long long* table, int n_leaves, int n_chunks,
                        int chunk, float lr, const float* lr_dev, float mom,
                        float wd, float damp, int nesterov, int scaled,
                        const unsigned char* finite, double* taps, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Leaf* leaves = reinterpret_cast<const Leaf*>(table);
  if (nesterov && scaled)
    launch_taps<true, true>(leaves, n_leaves, n_chunks, chunk, lr, lr_dev,
                            mom, wd, damp, finite, taps, st);
  else if (nesterov)
    launch_taps<true, false>(leaves, n_leaves, n_chunks, chunk, lr, lr_dev,
                             mom, wd, damp, finite, taps, st);
  else if (scaled)
    launch_taps<false, true>(leaves, n_leaves, n_chunks, chunk, lr, lr_dev,
                             mom, wd, damp, finite, taps, st);
  else
    launch_taps<false, false>(leaves, n_leaves, n_chunks, chunk, lr, lr_dev,
                              mom, wd, damp, finite, taps, st);
  return (int)cudaGetLastError();
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
