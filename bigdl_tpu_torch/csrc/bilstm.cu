// Direction-batched LSTM recurrence, forward and backward, fp32, for
// Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_bilstm_fwd_call` and
// `_bilstm_bwd_call` (the pair behind `bilstm_recurrence`).  Contract, as
// there, over the hoisted input projection zx (T, D, B, 4H) and the
// recurrent weights wht (D, H, 4H), D directions (1: Recurrent, 2:
// BiRecurrent; the kernels know nothing of reversal), h = c = 0 at t = 0:
//   z   = zx[t,d] + h . wht[d]             gates i, f, g, o: the four
//   c'  = sig(f) c + sig(i) tanh(g)        H-wide slices of z, in order
//   h'  = sig(o) tanh(c')                  -> hs[t,d] (and cs[t,d])
// and the backward in reverse time from dh = dc = 0, with hprev/cprev the
// step t-1 values (zeros at t = 0) and the gates recomputed from
// zx[t] + hprev . wht:
//   dh_tot = gout[t] + dh,  dc_tot = dc + dh_tot o (1 - tanh(c_t)^2)
//   dz     = [dc_tot g i(1-i), dc_tot cprev f(1-f), dc_tot i(1-g^2),
//             dh_tot tanh(c_t) o(1-o)]    -> dzx[t]
//   dh     = dz . wht[d]^T,  dc = dc_tot f
//   dwht[d] = sum_t hprev^T . dz           (a separate product)
// sig(x) = 1/(1+expf(-x)), tanhf: no fast math.
//
// What bounds it on this card: at the Bi-LSTM classifier's shapes (T 500,
// D 2, B 128, H 128) the recurrent products are 16.8 GFLOP each way
// (0.25 ms at the fp32 peak) against ~0.4 GB moved (0.12 ms), but the
// serial chain is what sets the time: every step needs the whole of
// wht[d] (256 KB, more than a block's 227 KB of shared memory) and the
// previous step's h.
//
// What this design does about it: one block per (direction, tile of
// kRows batch rows) walks all T steps in a loop, so no block waits for
// another (batch rows never interact) and no step needs a grid-wide
// barrier.  Its rows' h and c stay in shared memory; each step it reads
// wht[d] through L2 (512 KB for both directions stays resident in the
// 50 MB L2), kRows rows at a time, while cp.async stages the step's zx
// rows into shared memory under the product.  The backward first
// recomputes every step's gates in one parallel tiled product (they
// depend only on the stored h stack), so its serial loop carries only
// dz . wht^T; dwht is a second tiled product over dzx and the h stack,
// split over the time*batch axis into fixed slices summed in a fixed
// order: no atomics, the same bits every run.  The TPU kernel's VMEM-
// resident Wh, `block_t` grid steps and time padding exist for its
// sequential grid and have no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;        // batch rows of a recurrence block
constexpr int kThreads = 512;   // threads of a recurrence block
constexpr int kMaxSmem = 232448;
// ops/bilstm.py mirrors kRows, kThreads, kMaxSmem and the two shared-
// memory sizes below, and refuses an H whose blocks do not fit (H > 558)
// before it calls in here.
// tiled products: 64 x 64 outputs a block, 16-deep slices, 256 threads
// with 4 x 4 outputs each
constexpr int kBM = 64, kBN = 64, kBK = 16, kPad = 4, kGemmThreads = 256;

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

// out[r*N + n] = sum_m a[m*kRows + r] * W[m*N + n] for every r < kRows and
// n < N: `a` and `out` in shared memory, W (row-major M x N) read from
// global memory through L2.  With G > 1 the threads (g, n) each sum their
// slice of m into `red` and the slices are added in group order, so the
// result is the same bits every run.
__device__ void matvec(const float* __restrict__ W, int M, int N,
                       const float* __restrict__ a, float* __restrict__ out,
                       float* __restrict__ red, int G) {
  const int tid = threadIdx.x;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  for (int base = 0; base < (G > 1 ? 1 : N); base += kThreads) {
    const int g = G > 1 ? tid / N : 0;
    const int n = G > 1 ? tid % N : base + tid;
    if (g < G && n < N) {
      const int m0 = (int)((long long)g * M / G);
      const int m1 = (int)((long long)(g + 1) * M / G);
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      const float* w = W + n;
      int m = m0;
      for (; m + 8 <= m1; m += 8) {
        float wv[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) wv[q] = __ldg(w + (size_t)(m + q) * N);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 lo = a4[(m + q) * 2], hi = a4[(m + q) * 2 + 1];
          acc[0] = fmaf(lo.x, wv[q], acc[0]);
          acc[1] = fmaf(lo.y, wv[q], acc[1]);
          acc[2] = fmaf(lo.z, wv[q], acc[2]);
          acc[3] = fmaf(lo.w, wv[q], acc[3]);
          acc[4] = fmaf(hi.x, wv[q], acc[4]);
          acc[5] = fmaf(hi.y, wv[q], acc[5]);
          acc[6] = fmaf(hi.z, wv[q], acc[6]);
          acc[7] = fmaf(hi.w, wv[q], acc[7]);
        }
      }
      for (; m < m1; ++m) {
        const float wq = __ldg(w + (size_t)m * N);
        const float4 lo = a4[m * 2], hi = a4[m * 2 + 1];
        acc[0] = fmaf(lo.x, wq, acc[0]);
        acc[1] = fmaf(lo.y, wq, acc[1]);
        acc[2] = fmaf(lo.z, wq, acc[2]);
        acc[3] = fmaf(lo.w, wq, acc[3]);
        acc[4] = fmaf(hi.x, wq, acc[4]);
        acc[5] = fmaf(hi.y, wq, acc[5]);
        acc[6] = fmaf(hi.z, wq, acc[6]);
        acc[7] = fmaf(hi.w, wq, acc[7]);
      }
      float* dst = G > 1 ? red + (size_t)g * kRows * N : out;
#pragma unroll
      for (int r = 0; r < kRows; ++r) dst[r * N + n] = acc[r];
    }
  }
  if (G > 1) {
    __syncthreads();
    for (int e = tid; e < kRows * N; e += kThreads) {
      float s = red[e];
      for (int g = 1; g < G; ++g) s += red[(size_t)g * kRows * N + e];
      out[e] = s;
    }
  }
}

// Shared memory of the forward block, in floats.
__host__ __device__ inline int fwd_smem_floats(int H) {
  const int G = groups(H, 4 * H);
  return kRows * 10 * H + (G > 1 ? G * kRows * 4 * H : 0);
}

// Shared memory of the backward's serial block, in floats.
__host__ __device__ inline int bwd_smem_floats(int H) {
  const int G = groups(4 * H, H);
  return kRows * 13 * H + (G > 1 ? G * kRows * H : 0);
}

template <bool WITH_C>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const float* __restrict__ zx,
                    const float* __restrict__ wht, float* __restrict__ hs,
                    float* __restrict__ cs, Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = dm.H, H4 = 4 * H, tid = threadIdx.x;
  const int tiles = (dm.B + kRows - 1) / kRows;
  const int d = blockIdx.x / tiles, b0 = (blockIdx.x % tiles) * kRows;
  const int rows = min(kRows, dm.B - b0);
  float* h_s = smem;              // [H][kRows], rows past `rows` stay 0
  float* c_s = h_s + H * kRows;   // [rows][H]
  float* z_s = c_s + H * kRows;   // [kRows][4H]: h . wht
  float* x_s = z_s + H4 * kRows;  // [rows][4H]: this step's zx rows
  float* red = x_s + H4 * kRows;  // [G][kRows][4H]
  const int G = groups(H, H4);
  for (int e = tid; e < 2 * H * kRows; e += kThreads) smem[e] = 0.0f;
  const float* W = wht + (size_t)d * H * H4;
  __syncthreads();
  for (int t = 0; t < dm.T; ++t) {
    const size_t row0 = ((size_t)t * dm.D + d) * dm.B + b0;
    const float* src = zx + row0 * H4;
    for (int e = tid; e < rows * H4; e += kThreads)
      cp_async4(x_s + e, src + e);
    matvec(W, H, H4, h_s, z_s, red, G);
    cp_async_wait_all();
    __syncthreads();
    for (int p = tid; p < rows * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const float* x = x_s + r * H4;
      const float* z = z_s + r * H4;
      const float i = sigm(x[u] + z[u]);
      const float f = sigm(x[H + u] + z[H + u]);
      const float g = tanhf(x[2 * H + u] + z[2 * H + u]);
      const float o = sigm(x[3 * H + u] + z[3 * H + u]);
      const float c = f * c_s[p] + i * g;
      const float h = o * tanhf(c);
      c_s[p] = c;
      h_s[u * kRows + r] = h;
      const size_t at = (row0 + r) * H + u;
      hs[at] = h;
      if (WITH_C) cs[at] = c;
    }
    __syncthreads();
  }
}

// wh[d][j][k] = wht[d][k][j]: the backward's serial product reads wht^T
// with neighbouring threads on neighbouring k.
__global__ void transpose_kernel(const float* __restrict__ wht,
                                 float* __restrict__ wh, int D, int H) {
  const long long n = (long long)D * H * 4 * H;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int j = (int)(e % (4 * H));
    const long long dk = e / (4 * H);
    const int k = (int)(dk % H), d = (int)(dk / H);
    wh[((size_t)d * 4 * H + j) * H + k] = wht[e];
  }
}

// Row `kk` (= t * B + b) of direction d: the h stack at step t - 1, or
// null at t = 0 (the zero initial state).
__device__ __forceinline__ const float* hprev_row(const float* hs,
                                                  const Dims& dm, int d,
                                                  long long kk) {
  const long long t = kk / dm.B, b = kk - t * dm.B;
  if (t == 0) return nullptr;
  return hs + (((t - 1) * dm.D + d) * dm.B + b) * dm.H;
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

// The backward's gates, all steps at once: gates[t,d,b,:] =
// act(zx[t,d,b,:] + hprev[t,d,b,:] . wht[d]), sigmoid on i, f, o and tanh
// on g.  Rows m = t * B + b of direction blockIdx.z; a tiled product over
// k < H.
__global__ void __launch_bounds__(kGemmThreads)
    gates_kernel(const float* __restrict__ zx, const float* __restrict__ wht,
                 const float* __restrict__ hs, float* __restrict__ gates,
                 Dims dm) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const int H = dm.H, H4 = 4 * H, d = blockIdx.z, tid = threadIdx.x;
  const long long M = (long long)dm.T * dm.B;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ty = tid / 16, tx = tid % 16;
  const float* W = wht + (size_t)d * H * H4;
  // loaders: A rows (m, 4 consecutive k), B rows (k, 4 consecutive n)
  const int am = tid / 4, ak = (tid % 4) * 4;
  const int bk = tid / 16, bn = (tid % 16) * 4;
  const float* arow =
      m0 + am < M ? hprev_row(hs, dm, d, m0 + am) : nullptr;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < H; k0 += kBK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + ak + q;
      As[ak + q][am] = (arow != nullptr && k < H) ? arow[k] : 0.0f;
      const int n = n0 + bn + q, kb = k0 + bk;
      Bs[bk][bn + q] = (kb < H && n < H4) ? W[(size_t)kb * H4 + n] : 0.0f;
    }
    __syncthreads();
    tile_fma(As, Bs, acc, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= M) continue;
    const long long t = m / dm.B, b = m - t * dm.B;
    const size_t row = ((size_t)t * dm.D + d) * dm.B + b;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= H4) continue;
      const float v = zx[row * H4 + n] + acc[i][j];
      gates[row * H4 + n] = (n / H == 2) ? tanhf(v) : sigm(v);
    }
  }
}

// The serial part of the backward: one block per (direction, row tile)
// in reverse time.  `dzx` holds the activated gates on entry (from
// gates_kernel) and dz on exit, each step's rows overwritten by the
// block that staged them.
__global__ void __launch_bounds__(kThreads)
    lstm_bwd_kernel(float* __restrict__ dzx, const float* __restrict__ cs,
                    const float* __restrict__ gout,
                    const float* __restrict__ wh, Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = dm.H, H4 = 4 * H, tid = threadIdx.x;
  const int tiles = (dm.B + kRows - 1) / kRows;
  const int d = blockIdx.x / tiles, b0 = (blockIdx.x % tiles) * kRows;
  const int rows = min(kRows, dm.B - b0);
  float* dz_s = smem;              // [4H][kRows]: dz of step t + 1
  float* dh_s = dz_s + H4 * kRows;  // [kRows][H]: dz . wht^T
  float* dc_s = dh_s + H * kRows;   // [rows][H]
  float* g_s = dc_s + H * kRows;    // [rows][4H]: step t's gates
  float* c_s = g_s + H4 * kRows;    // [rows][H]: c_t
  float* cp_s = c_s + H * kRows;    // [rows][H]: c_{t-1}
  float* go_s = cp_s + H * kRows;   // [rows][H]: gout[t]
  float* red = go_s + H * kRows;    // [G][kRows][H]
  const int G = groups(H4, H);
  for (int e = tid; e < 6 * H * kRows; e += kThreads) smem[e] = 0.0f;
  const float* W = wh + (size_t)d * H4 * H;
  __syncthreads();
  for (int t = dm.T - 1; t >= 0; --t) {
    const size_t row0 = ((size_t)t * dm.D + d) * dm.B + b0;
    for (int e = tid; e < rows * H4; e += kThreads)
      cp_async4(g_s + e, dzx + row0 * H4 + e);
    const float* c_prev = cs + (row0 - (size_t)dm.D * dm.B) * H;
    for (int e = tid; e < rows * H; e += kThreads) {
      cp_async4(c_s + e, cs + row0 * H + e);
      cp_async4(go_s + e, gout + row0 * H + e);
      if (t > 0) cp_async4(cp_s + e, c_prev + e);
    }
    matvec(W, H4, H, dz_s, dh_s, red, G);
    cp_async_wait_all();
    __syncthreads();
    for (int p = tid; p < rows * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const float* gr = g_s + r * H4;
      const float i = gr[u], f = gr[H + u], g = gr[2 * H + u],
                  o = gr[3 * H + u];
      const float cprev = t > 0 ? cp_s[p] : 0.0f;
      const float tc = tanhf(c_s[p]);
      const float dh_tot = go_s[p] + dh_s[p];
      const float dc_tot = dc_s[p] + dh_tot * o * (1.0f - tc * tc);
      const float dz[4] = {dc_tot * g * i * (1.0f - i),
                           dc_tot * cprev * f * (1.0f - f),
                           dc_tot * i * (1.0f - g * g),
                           dh_tot * tc * o * (1.0f - o)};
      float* out = dzx + (row0 + r) * H4 + u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        out[q * H] = dz[q];
        dz_s[(q * H + u) * kRows + r] = dz[q];
      }
      dc_s[p] = dc_tot * f;
    }
    __syncthreads();
  }
}

// dwht partial sums: part[s][d][k][j] = sum over rows kk of slice s of
// hprev[kk][k] * dzx[kk][j], kk = t * B + b of direction blockIdx.z; a
// tiled product over the time*batch axis.
__global__ void __launch_bounds__(kGemmThreads)
    dwh_kernel(const float* __restrict__ hs, const float* __restrict__ dzx,
               float* __restrict__ part, Dims dm, long long slice) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const int H = dm.H, H4 = 4 * H, d = blockIdx.z, s = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nt = (H4 + kBN - 1) / kBN;
  const int k0 = (blockIdx.x / nt) * kBM, n0 = (blockIdx.x % nt) * kBN;
  const long long M = (long long)dm.T * dm.B;
  const long long kk0 = s * slice;
  const long long kk1 = kk0 + slice < M ? kk0 + slice : M;
  const int lr = tid / 16, lc = (tid % 16) * 4;  // loader row, 4 columns
  // each 16-row slice is summed from zero, then added to `acc`: a chain of
  // 16 + rows/16 roundings per output, not one of `slice` (~3,800 at the
  // classifier's shape), so the sum's fp32 error stays near cuBLAS's
  float acc[4][4] = {};
  for (long long kb = kk0; kb < kk1; kb += kBK) {
    const long long kk = kb + lr;
    const float* hrow = kk < kk1 ? hprev_row(hs, dm, d, kk) : nullptr;
    const float* zrow = nullptr;
    if (kk < kk1) {
      const long long t = kk / dm.B, b = kk - t * dm.B;
      zrow = dzx + ((t * dm.D + d) * dm.B + b) * H4;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + lc + q, n = n0 + lc + q;
      As[lr][lc + q] = (hrow != nullptr && k < H) ? hrow[k] : 0.0f;
      Bs[lr][lc + q] = (zrow != nullptr && n < H4) ? zrow[n] : 0.0f;
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
  float* out = part + ((size_t)s * dm.D + d) * H * H4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= H) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < H4) out[(size_t)k * H4 + n] = acc[i][j];
    }
  }
}

// dwht[e] = sum_s part[s][e], slices in order.
__global__ void sum_slices_kernel(const float* __restrict__ part,
                                  float* __restrict__ dwht, long long n,
                                  int S) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    float acc = part[e];
    for (int s = 1; s < S; ++s) acc += part[(size_t)s * n + e];
    dwht[e] = acc;
  }
}

cudaError_t set_smem(const void* fn, int bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

bool empty(const Dims& dm) {
  return dm.T == 0 || dm.D == 0 || dm.B == 0 || dm.H == 0;
}

}  // namespace

extern "C" {

// Forward over zx (T, D, B, 4H) and wht (D, H, 4H): hs (T, D, B, H) and,
// unless `cs` is null (the primal variant), cs.  One launch.  Returns the
// cudaError_t of the launch.
int bigdl_lstm_fwd_f32(const float* zx, const float* wht, float* hs,
                       float* cs, int T, int D, int B, int H, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes = fwd_smem_floats(H) * (int)sizeof(float);
  const dim3 grid(D * ((B + kRows - 1) / kRows));
  if (cs != nullptr) {
    err = set_smem((const void*)lstm_fwd_kernel<true>, bytes);
    if (err != cudaSuccess) return (int)err;
    lstm_fwd_kernel<true><<<grid, kThreads, bytes, st>>>(zx, wht, hs, cs, dm);
  } else {
    err = set_smem((const void*)lstm_fwd_kernel<false>, bytes);
    if (err != cudaSuccess) return (int)err;
    lstm_fwd_kernel<false><<<grid, kThreads, bytes, st>>>(zx, wht, hs,
                                                         nullptr, dm);
  }
  return (int)cudaGetLastError();
}

// Backward: dzx (T, D, B, 4H) from the forward's zx, wht, hs and cs and
// the cotangent gout (T, D, B, H).  `wh` is scratch of D * 4H * H floats.
// Three launches on the stream: wht^T, the gates of every step, the
// serial loop.
int bigdl_lstm_bwd_f32(const float* zx, const float* wht, const float* hs,
                       const float* cs, const float* gout, float* dzx,
                       float* wh, int T, int D, int B, int H, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes = bwd_smem_floats(H) * (int)sizeof(float);
  err = set_smem((const void*)lstm_bwd_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  transpose_kernel<<<(D * 4 * H * H + 255) / 256, 256, 0, st>>>(wht, wh, D,
                                                                H);
  const long long M = (long long)T * B;
  const dim3 ggrid((unsigned)((M + kBM - 1) / kBM), (4 * H + kBN - 1) / kBN,
                   D);
  gates_kernel<<<ggrid, kGemmThreads, 0, st>>>(zx, wht, hs, dzx, dm);
  const dim3 grid(D * ((B + kRows - 1) / kRows));
  lstm_bwd_kernel<<<grid, kThreads, bytes, st>>>(dzx, cs, gout, wh, dm);
  return (int)cudaGetLastError();
}

// dwht (D, H, 4H) = sum over t, b of hprev^T . dzx, the time*batch axis cut
// into S slices of `slice` rows; `part` is scratch of S * D * H * 4H
// floats.  Two launches: the sliced products, then their sum in order.
int bigdl_lstm_dwh_f32(const float* hs, const float* dzx, float* part,
                       float* dwht, int T, int D, int B, int H, int S,
                       long long slice, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (D == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = (long long)D * H * 4 * H;
  if (T == 0 || B == 0) return (int)cudaMemsetAsync(dwht, 0, n * 4, st);
  if (S < 1 || slice < 1) return (int)cudaErrorInvalidValue;
  const int tiles = ((H + kBM - 1) / kBM) * ((4 * H + kBN - 1) / kBN);
  dwh_kernel<<<dim3(tiles, S, D), kGemmThreads, 0, st>>>(hs, dzx, part, dm,
                                                         slice);
  sum_slices_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, dwht,
                                                                 n, S);
  return (int)cudaGetLastError();
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
