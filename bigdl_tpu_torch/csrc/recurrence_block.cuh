// What the recurrence kernels (bilstm.cu, rnn.cu, gru.cu) share: the
// block that walks all T steps of a tile of batch rows, and the rule
// that sizes it.
//
// A recurrence block keeps its rows' state in shared memory, which grows
// with the batch rows it holds and with H.  The row rule: a block takes
// the most of 8, 4, 2 or 1 rows whose forward and backward blocks both
// fit a block's 227 KB (`rows_for`); above the 1-row limit the wrappers
// refuse H before any launch.  ops/_recurrence.py mirrors kRowChoices,
// kThreads, kMaxSmem and `groups`.
#pragma once

#include <cuda_runtime.h>

// Everything here lives in an anonymous namespace, as each kernel source
// is its own library (and the profiler's kernel names read
// "(anonymous namespace)::").
namespace {

constexpr int kThreads = 512;   // threads of a recurrence block
constexpr int kMaxSmem = 232448;
constexpr int kRowChoices[] = {8, 4, 2, 1};

struct Dims {
  int T, D, B, H;
};

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Groups that split the M-long reduction of an N-wide product across the
// block: enough (n, group) threads to use the block, at most one per m.
__host__ __device__ inline int groups(int M, int N) {
  if (N >= kThreads) return 1;
  const int g = kThreads / N;
  return g < M ? g : M;
}

// The R values a[m * R + r], r < R, loaded as wide as R allows.
template <int R>
__device__ __forceinline__ void load_rows(const float* a, int m,
                                          float (&v)[R]) {
  if constexpr (R == 8) {
    const float4 lo = reinterpret_cast<const float4*>(a)[m * 2];
    const float4 hi = reinterpret_cast<const float4*>(a)[m * 2 + 1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else if constexpr (R == 4) {
    const float4 q = reinterpret_cast<const float4*>(a)[m];
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (R == 2) {
    const float2 q = reinterpret_cast<const float2*>(a)[m];
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = a[m];
  }
}

template <bool SHARED>
__device__ __forceinline__ float load_w(const float* w) {
  if constexpr (SHARED) {
    return *w;
  } else {
    return __ldg(w);
  }
}

// acc[r] += sum over m0 <= m < m1 of a[m*R + r] * w[m*N], one fmaf chain
// per row, in order of m.
template <int R, bool W_SHARED>
__device__ __forceinline__ void dot_rows(const float* w, int N,
                                         const float* a, int m0, int m1,
                                         float (&acc)[R]) {
  int m = m0;
  for (; m + 8 <= m1; m += 8) {
    float wv[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      wv[q] = load_w<W_SHARED>(w + (size_t)(m + q) * N);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float v[R];
      load_rows<R>(a, m + q, v);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(v[r], wv[q], acc[r]);
    }
  }
  for (; m < m1; ++m) {
    const float wq = load_w<W_SHARED>(w + (size_t)m * N);
    float v[R];
    load_rows<R>(a, m, v);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(v[r], wq, acc[r]);
  }
}

// out[r*N + n] = sum_m a[m*R + r] * W[m*N + n] for every r < R and n < N:
// `a` and `out` in shared memory, W (row-major M x N) in shared memory
// (W_SHARED) or read from global memory through L2.  With G > 1 the
// threads (g, n) each sum their slice of m into `red` and the slices are
// added in group order, so the result is the same bits every run.  With
// CHUNK > 0 a thread sums each run of CHUNK values of m from zero, each
// run of CHUNK such sums from zero, and adds those to its total: at a
// large M (the RNN's H goes to 14,528) one chain of M roundings leaves
// the result about ten times further from the exact sum than a blocked
// fp32 product, the two levels within its error.  CHUNK = 0 is the one
// chain (bilstm.cu's bits).
// The caller synchronises before reading `out`.
template <int R, bool W_SHARED = false, int CHUNK = 0>
__device__ void matvec(const float* __restrict__ W, int M, int N,
                       const float* __restrict__ a, float* __restrict__ out,
                       float* __restrict__ red, int G) {
  const int tid = threadIdx.x;
  for (int base = 0; base < (G > 1 ? 1 : N); base += kThreads) {
    const int g = G > 1 ? tid / N : 0;
    const int n = G > 1 ? tid % N : base + tid;
    if (g < G && n < N) {
      const int m0 = (int)((long long)g * M / G);
      const int m1 = (int)((long long)(g + 1) * M / G);
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      if constexpr (CHUNK == 0) {
        dot_rows<R, W_SHARED>(W + n, N, a, m0, m1, acc);
      } else {
        // two levels: runs of CHUNK products, then runs of CHUNK of those
        for (int s0 = m0; s0 < m1; s0 += CHUNK * CHUNK) {
          const int s1 = min(s0 + CHUNK * CHUNK, m1);
          float mid[R];
#pragma unroll
          for (int r = 0; r < R; ++r) mid[r] = 0.0f;
          for (int c0 = s0; c0 < s1; c0 += CHUNK) {
            float part[R];
#pragma unroll
            for (int r = 0; r < R; ++r) part[r] = 0.0f;
            dot_rows<R, W_SHARED>(W + n, N, a, c0, min(c0 + CHUNK, s1),
                                  part);
#pragma unroll
            for (int r = 0; r < R; ++r) mid[r] += part[r];
          }
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] += mid[r];
        }
      }
      float* dst = G > 1 ? red + (size_t)g * R * N : out;
#pragma unroll
      for (int r = 0; r < R; ++r) dst[r * N + n] = acc[r];
    }
  }
  if (G > 1) {
    __syncthreads();
    for (int e = tid; e < R * N; e += kThreads) {
      float s = red[e];
      for (int g = 1; g < G; ++g) s += red[(size_t)g * R * N + e];
      out[e] = s;
    }
  }
}

// wt[d][j][k] = w[d][k][j] for w (D, K, J): a serial product reads the
// transposed weight with neighbouring threads on neighbouring k.
__global__ void transpose_kernel(const float* __restrict__ w,
                                 float* __restrict__ wt, int D, int K,
                                 int J) {
  const long long n = (long long)D * K * J;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(e % J);
    const long long dk = e / J;
    const int k = (int)(dk % K), d = (int)(dk / K);
    wt[((size_t)d * J + j) * K + k] = w[e];
  }
}

inline void launch_transpose(const float* w, float* wt, int D, int K, int J,
                             cudaStream_t st) {
  const long long n = (long long)D * K * J;
  transpose_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(w, wt, D, K,
                                                                J);
}

// The row rule: the most of kRowChoices rows a block whose blocks at
// `rows` need `bytes(rows)` bytes of shared memory at most (the larger of
// the forward's and the backward's) can take; 0 when not even one fits.
template <class Bytes>
inline int rows_for(Bytes bytes) {
  for (int rows : kRowChoices)
    if (bytes(rows) <= kMaxSmem) return rows;
  return 0;
}

inline cudaError_t set_smem(const void* fn, int bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

inline bool empty(const Dims& dm) {
  return dm.T == 0 || dm.D == 0 || dm.B == 0 || dm.H == 0;
}

}  // namespace
