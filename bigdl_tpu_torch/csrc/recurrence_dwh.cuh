// The recurrence kernels' weight gradient, shared by bilstm.cu, rnn.cu
// and gru.cu, the tiled product it is built from, and the backward's
// pre-pass over every step at once (gru.cu's gates, rnn.cu's
// pre-activation).
//
// dw[d] (K x J) = sum over the time*batch rows kk = t * B + b of
// left[kk]^T . right[kk], where `right` is a (T, D, B, J) stack (dz) and
// `left` a (T, D, B, K) stack read either at t (GRU's r o hprev) or at
// t - 1, with the initial state or zeros at t = 0 (the h stack).  The
// time*batch axis is split into S slices fixed by the shape; each slice
// is one tiled product, and the slices are summed in order: no atomics,
// the same bits every run.
#pragma once

#include <cuda_runtime.h>

namespace {

// tiled products: 64 x 64 outputs a block, 16-deep slices, 256 threads
// with 4 x 4 outputs each
constexpr int kBM = 64, kBN = 64, kBK = 16, kPad = 4, kGemmThreads = 256;

// A (T, D, B, K) stack as the left operand of a tiled product.
struct Stack {
  const float* x;    // (T, D, B, K)
  const float* x0;   // (D, B, K): row t = 0 when `shifted`; null for zeros
  bool shifted;      // row t reads x at t - 1
};

// Row kk (= t * B + b) of direction d of `s`, or null for a zero row.
__device__ __forceinline__ const float* stack_row(const Stack& s, int D,
                                                  int B, int K, int d,
                                                  long long kk) {
  const long long t = kk / B, b = kk - t * B;
  if (!s.shifted) return s.x + ((t * D + d) * B + b) * K;
  if (t == 0) return s.x0 == nullptr ? nullptr : s.x0 + ((long long)d * B + b) * K;
  return s.x + (((t - 1) * D + d) * B + b) * K;
}

// acc[i][j] += As[k][ty*4 + i] * Bs[k][tx*4 + j] over one 16-deep slice.
__device__ __forceinline__ void tile_fma(float (*As)[kBM + kPad],
                                         float (*Bs)[kBN + kPad],
                                         float (&acc)[4][4], int ty, int tx) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

struct DwhShape {
  int T, D, B, K, J;
  long long slice;   // time*batch rows a slice
};

// Partial sums: part[s][d][k][j] = sum over rows kk of slice s of
// left[kk][k] * right[kk][j], direction blockIdx.z, slice blockIdx.y.
__global__ void __launch_bounds__(kGemmThreads)
    dwh_kernel(Stack left, const float* __restrict__ right,
               float* __restrict__ part, DwhShape sh) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const int K = sh.K, J = sh.J, d = blockIdx.z, s = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nt = (J + kBN - 1) / kBN;
  const int k0 = (blockIdx.x / nt) * kBM, n0 = (blockIdx.x % nt) * kBN;
  const long long M = (long long)sh.T * sh.B;
  const long long kk0 = s * sh.slice;
  const long long kk1 = kk0 + sh.slice < M ? kk0 + sh.slice : M;
  const int lr = tid / 16, lc = (tid % 16) * 4;  // loader row, 4 columns
  // each 16-row slice is summed from zero, then added to `acc`: a chain of
  // 16 + rows/16 roundings per output, not one of `slice` (~3,800 at the
  // classifier's shape), so the sum's fp32 error stays near cuBLAS's
  float acc[4][4] = {};
  for (long long kb = kk0; kb < kk1; kb += kBK) {
    const long long kk = kb + lr;
    const float* lrow =
        kk < kk1 ? stack_row(left, sh.D, sh.B, K, d, kk) : nullptr;
    const float* rrow = nullptr;
    if (kk < kk1) {
      const long long t = kk / sh.B, b = kk - t * sh.B;
      rrow = right + ((t * sh.D + d) * sh.B + b) * J;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + lc + q, n = n0 + lc + q;
      As[lr][lc + q] = (lrow != nullptr && k < K) ? lrow[k] : 0.0f;
      Bs[lr][lc + q] = (rrow != nullptr && n < J) ? rrow[n] : 0.0f;
    }
    __syncthreads();
    float blk[4][4] = {};
    tile_fma(As, Bs, blk, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += blk[i][j];
    __syncthreads();
  }
  float* out = part + ((size_t)s * sh.D + d) * K * J;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < J) out[(size_t)k * J + n] = acc[i][j];
    }
  }
}

// The pre-pass's epilogue: none, the sigmoid or tanh.
enum Epi { kIdentity, kSigmoid, kTanh };

// A backward's pre-pass, all steps at once, as a tiled product over k < K
// of the stack `left` and W[d] (K x J): out[row, n] = EPI(in[row, n] +
// left[row] . W[d][:, n]) for rows m = t * B + b of direction blockIdx.z
// (sh.slice unused).  With RH, columns n < K also write rh[row, n] =
// out[row, n] * left[row][n] (gru.cu: r o hprev, `left` the h stack at
// t - 1).
template <int EPI, bool RH>
__global__ void __launch_bounds__(kGemmThreads)
    prepass_kernel(const float* __restrict__ in,
                   const float* __restrict__ w, Stack left,
                   float* __restrict__ out, float* __restrict__ rh,
                   DwhShape sh) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const int H = sh.K, J = sh.J, d = blockIdx.z, tid = threadIdx.x;
  const long long M = (long long)sh.T * sh.B;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ty = tid / 16, tx = tid % 16;
  const float* W = w + (size_t)d * H * J;
  const int am = tid / 4, ak = (tid % 4) * 4;
  const int bk = tid / 16, bn = (tid % 16) * 4;
  const float* arow =
      m0 + am < M ? stack_row(left, sh.D, sh.B, H, d, m0 + am) : nullptr;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < H; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + ak + q;
      As[ak + q][am] = (arow != nullptr && k < H) ? arow[k] : 0.0f;
      const int n = n0 + bn + q, kb = k0 + bk;
      Bs[bk][bn + q] = (kb < H && n < J) ? W[(size_t)kb * J + n] : 0.0f;
    }
    __syncthreads();
    tile_fma(As, Bs, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const long long t = m / sh.B, b = m - t * sh.B;
    const size_t row = ((size_t)t * sh.D + d) * sh.B + b;
    const float* hp = RH ? stack_row(left, sh.D, sh.B, H, d, m) : nullptr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= J) continue;
      const float v = in[row * J + n] + acc[i][j];
      const float a = EPI == kTanh      ? tanhf(v)
                      : EPI == kSigmoid ? 1.0f / (1.0f + expf(-v))
                                        : v;
      out[row * J + n] = a;
      if (RH && n < H) rh[row * H + n] = hp != nullptr ? a * hp[n] : 0.0f;
    }
  }
}

// The pre-pass's launch: rows t * B + b of D directions, J columns.
template <int EPI, bool RH>
void launch_prepass(const float* in, const float* w, const Stack& left,
                  float* out, float* rh, const DwhShape& sh, cudaStream_t st) {
  const long long M = (long long)sh.T * sh.B;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (sh.J + kBN - 1) / kBN,
                  sh.D);
  prepass_kernel<EPI, RH><<<grid, kGemmThreads, 0, st>>>(in, w, left, out,
                                                          rh, sh);
}

// dw[e] = sum_s part[s][e], slices in order.
__global__ void sum_slices_kernel(const float* __restrict__ part,
                                  float* __restrict__ dw, long long n,
                                  int S) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float acc = part[e];
    for (int s = 1; s < S; ++s) acc += part[(size_t)s * n + e];
    dw[e] = acc;
  }
}

// dw (D, K, J) from `left` and `right` in S slices of `sh.slice` rows;
// `part` is scratch of S * D * K * J floats.  Two launches on `st`: the
// sliced products, then their sum in order (a zero fill when T * B is 0).
inline cudaError_t launch_dwh(const Stack& left, const float* right,
                              float* part, float* dw, const DwhShape& sh,
                              int S, cudaStream_t st) {
  if (sh.D == 0 || sh.K == 0 || sh.J == 0) return cudaSuccess;
  const long long n = (long long)sh.D * sh.K * sh.J;
  if (sh.T == 0 || sh.B == 0) return cudaMemsetAsync(dw, 0, n * 4, st);
  if (S < 1 || sh.slice < 1) return cudaErrorInvalidValue;
  const int tiles = ((sh.K + kBM - 1) / kBM) * ((sh.J + kBN - 1) / kBN);
  dwh_kernel<<<dim3(tiles, S, sh.D), kGemmThreads, 0, st>>>(left, right, part,
                                                            sh);
  sum_slices_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, dw, n,
                                                                 S);
  return cudaGetLastError();
}

}  // namespace
