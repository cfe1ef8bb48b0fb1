// Direction-batched GRU recurrence, forward and backward, fp32, for
// Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_gru_fwd_call` and
// `_gru_bwd_call` (the pair behind `gru_recurrence`).  Contract, as
// there, over the hoisted input projections zrz (T, D, B, 2H) and zn
// (T, D, B, H) (biases added) and the recurrent weights wrz (D, H, 2H)
// and wh (D, H, H), D directions, h = 0 at t = 0:
//   r, z = sig(zrz[t,d] + h . wrz[d])       the two H-wide halves
//   n    = tanh(zn[t,d] + (r o h) . wh[d])
//   h'   = (1 - z) n + z h                  -> hs[t,d]
// and the backward in reverse time from dh = 0, with hprev the step t-1
// value (zeros at t = 0) and r, z, n recomputed from the h stack:
//   dh_tot = gout[t] + dh
//   dn     = dh_tot (1 - z)(1 - n^2)                    -> dzn[t]
//   drh    = dn . wh[d]^T
//   dzrz   = [drh hprev r(1-r), dh_tot (hprev - n) z(1-z)] -> dzrz[t]
//   dh     = dh_tot z + drh r + dzrz . wrz[d]^T
//   dwrz[d] = sum_t hprev^T . dzrz,  dwh[d] = sum_t (r o hprev)^T . dn
// (_gru_gates / _gru_bwd_kernel's math exactly).  sig(x) = 1/(1+expf(-x)),
// tanhf: no fast math.
//
// What bounds it on this card: at (500, 2, 128, 128) the recurrent
// products are 12.6 GFLOP forward and 25 backward (0.19 / 0.38 ms at the
// fp32 peak) against ~0.3 GB moved; the serial chain of T steps, each two
// dependent products that need the previous step's h and all of wrz[d]
// and wh[d] (192 KB at H 128), sets the time.
//
// What this design does about it: bilstm.cu's block.  One block per
// (direction, tile of R batch rows) walks all T steps with its rows' h in
// shared memory, reading wrz[d] and wh[d] through L2 (384 KB for both
// directions stays resident in the 50 MB L2); forward, two products a
// step with a barrier between.  The backward first recomputes r, z for
// every step in one tiled product (they depend only on the stored h
// stack), writing r o hprev beside them, then n in a second one, so its
// serial loop carries only dn . wh^T and then dzrz . wrz^T, from the
// weights transposed once.  Both weight gradients are tiled products of
// recurrence_dwh.cuh.  R follows the row rule of recurrence_block.cuh.

#include "recurrence_block.cuh"
#include "recurrence_dwh.cuh"

namespace {

// each run of kChunk products summed from zero, then added (matvec)
constexpr int kChunk = 32;

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Reduction buffer of a block at R rows: the larger of its two products'.
__host__ __device__ inline int red_floats(int G1, int N1, int G2, int N2,
                                          int R) {
  return imax(G1 > 1 ? G1 * R * N1 : 0, G2 > 1 ? G2 * R * N2 : 0);
}

// Shared memory of the forward block at R rows, in floats: products
// h . wrz (H -> 2H) and (r o h) . wh (H -> H).
__host__ __device__ inline int gru_fwd_smem_floats(int H, int R) {
  return R * 9 * H + red_floats(groups(H, 2 * H), 2 * H, groups(H, H), H, R);
}

// Shared memory of the backward's serial block at R rows: products
// dn . wh^T (H -> H) and dzrz . wrz^T (2H -> H).
__host__ __device__ inline int gru_bwd_smem_floats(int H, int R) {
  return R * 11 * H + red_floats(groups(H, H), H, groups(2 * H, H), H, R);
}

inline int gru_rows(int H) {
  return rows_for([H](int r) {
    return 4 * imax(gru_fwd_smem_floats(H, r), gru_bwd_smem_floats(H, r));
  });
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    gru_fwd_kernel(const float* __restrict__ zrz,
                   const float* __restrict__ zn,
                   const float* __restrict__ wrz,
                   const float* __restrict__ wh, float* __restrict__ hs,
                   Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = dm.H, H2 = 2 * H, tid = threadIdx.x;
  const int tiles = (dm.B + R - 1) / R;
  const int d = blockIdx.x / tiles, b0 = (blockIdx.x % tiles) * R;
  const int rows = min(R, dm.B - b0);
  float* h_s = smem;              // [H][R], rows past `rows` stay 0
  float* rh_s = h_s + H * R;      // [H][R]: r o h
  float* p1 = rh_s + H * R;       // [R][2H]: h . wrz
  float* p2 = p1 + H2 * R;        // [R][H]: (r o h) . wh
  float* xrz = p2 + H * R;        // [rows][2H]: this step's zrz rows
  float* xn = xrz + H2 * R;       // [rows][H]: this step's zn rows
  float* z_s = xn + H * R;        // [rows][H]: z
  float* red = z_s + H * R;
  const int G1 = groups(H, H2), G2 = groups(H, H);
  for (int e = tid; e < 2 * H * R; e += kThreads) smem[e] = 0.0f;
  const float* Wrz = wrz + (size_t)d * H * H2;
  const float* Wh = wh + (size_t)d * H * H;
  __syncthreads();
  for (int t = 0; t < dm.T; ++t) {
    const size_t row0 = ((size_t)t * dm.D + d) * dm.B + b0;
    for (int e = tid; e < rows * H2; e += kThreads)
      cp_async4(xrz + e, zrz + row0 * H2 + e);
    for (int e = tid; e < rows * H; e += kThreads)
      cp_async4(xn + e, zn + row0 * H + e);
    matvec<R, false, kChunk>(Wrz, H, H2, h_s, p1, red, G1);
    cp_async_wait_all();
    __syncthreads();
    for (int p = tid; p < rows * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const float* x = xrz + r * H2;
      const float* q = p1 + r * H2;
      const float rr = sigm(x[u] + q[u]);
      z_s[p] = sigm(x[H + u] + q[H + u]);
      rh_s[u * R + r] = rr * h_s[u * R + r];
    }
    __syncthreads();
    matvec<R, false, kChunk>(Wh, H, H, rh_s, p2, red, G2);
    __syncthreads();
    for (int p = tid; p < rows * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const float n = tanhf(xn[p] + p2[p]);
      const float z = z_s[p], h = h_s[u * R + r];
      const float hn = (1.0f - z) * n + z * h;
      h_s[u * R + r] = hn;
      hs[(row0 + r) * H + u] = hn;
    }
    __syncthreads();
  }
}

// The backward's gates, all steps at once, as a tiled product over k < H
// of the stack `left` and W[d] (H x J): out[row, n] = act(in[row, n] +
// left[row] . W[d][:, n]) for rows m = t * B + b of direction blockIdx.z.
// TANH picks tanh (n) or the sigmoid (r, z); with RH the r half also
// writes rh[row, n] = r * hprev[row, n] (left is the h stack at t - 1).
template <bool TANH, bool RH>
__global__ void __launch_bounds__(kGemmThreads)
    gates_kernel(const float* __restrict__ in, const float* __restrict__ w,
                 Stack left, float* __restrict__ out, float* __restrict__ rh,
                 Dims dm, int J) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const int H = dm.H, d = blockIdx.z, tid = threadIdx.x;
  const long long M = (long long)dm.T * dm.B;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ty = tid / 16, tx = tid % 16;
  const float* W = w + (size_t)d * H * J;
  const int am = tid / 4, ak = (tid % 4) * 4;
  const int bk = tid / 16, bn = (tid % 16) * 4;
  const float* arow =
      m0 + am < M ? stack_row(left, dm.D, dm.B, H, d, m0 + am) : nullptr;
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
    const long long t = m / dm.B, b = m - t * dm.B;
    const size_t row = ((size_t)t * dm.D + d) * dm.B + b;
    const float* hp = RH ? stack_row(left, dm.D, dm.B, H, d, m) : nullptr;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= J) continue;
      const float v = in[row * J + n] + acc[i][j];
      const float a = TANH ? tanhf(v) : sigm(v);
      out[row * J + n] = a;
      if (RH && n < H) rh[row * H + n] = hp != nullptr ? a * hp[n] : 0.0f;
    }
  }
}

// The serial part of the backward: one block per (direction, row tile)
// in reverse time.  `dzrz` holds r, z and `dzn` holds n on entry (from
// gates_kernel), dz on exit, each step's rows overwritten by the block
// that staged them.  `wrzt` (D, 2H, H) and `wht` (D, H, H) are the
// weights transposed.
template <int R>
__global__ void __launch_bounds__(kThreads)
    gru_bwd_kernel(float* __restrict__ dzrz, float* __restrict__ dzn,
                   const float* __restrict__ hs,
                   const float* __restrict__ gout,
                   const float* __restrict__ wrzt,
                   const float* __restrict__ wht, Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = dm.H, H2 = 2 * H, tid = threadIdx.x;
  const int tiles = (dm.B + R - 1) / R;
  const int d = blockIdx.x / tiles, b0 = (blockIdx.x % tiles) * R;
  const int rows = min(R, dm.B - b0);
  float* dh_s = smem;              // [R][H]: dh carried, then dh_tot
  float* dq_s = dh_s + H * R;      // [R][H]: dzrz . wrz^T of step t + 1
  float* dn_s = dq_s + H * R;      // [H][R]: dn
  float* dzrz_s = dn_s + H * R;    // [2H][R]: dzrz
  float* drh_s = dzrz_s + H2 * R;  // [R][H]: dn . wh^T
  float* rz_s = drh_s + H * R;     // [rows][2H]: r, z of step t
  float* n_s = rz_s + H2 * R;      // [rows][H]: n of step t
  float* g_s = n_s + H * R;        // [rows][H]: gout[t]
  float* hp_s = g_s + H * R;       // [rows][H]: h_{t-1}
  float* red = hp_s + H * R;
  const int G1 = groups(H, H), G2 = groups(H2, H);
  for (int e = tid; e < 6 * H * R; e += kThreads) smem[e] = 0.0f;
  const float* Wht = wht + (size_t)d * H * H;
  const float* Wrzt = wrzt + (size_t)d * H2 * H;
  __syncthreads();
  for (int t = dm.T - 1; t >= 0; --t) {
    const size_t row0 = ((size_t)t * dm.D + d) * dm.B + b0;
    for (int e = tid; e < rows * H2; e += kThreads)
      cp_async4(rz_s + e, dzrz + row0 * H2 + e);
    const float* h_prev = hs + (row0 - (size_t)dm.D * dm.B) * H;
    for (int e = tid; e < rows * H; e += kThreads) {
      cp_async4(n_s + e, dzn + row0 * H + e);
      cp_async4(g_s + e, gout + row0 * H + e);
      if (t > 0) cp_async4(hp_s + e, h_prev + e);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int p = tid; p < rows * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const float z = rz_s[r * H2 + H + u], n = n_s[p];
      const float dh_tot = g_s[p] + (dh_s[p] + dq_s[p]);
      const float dn = dh_tot * (1.0f - z) * (1.0f - n * n);
      dh_s[p] = dh_tot;
      dn_s[u * R + r] = dn;
      dzn[(row0 + r) * H + u] = dn;
    }
    __syncthreads();
    matvec<R, false, kChunk>(Wht, H, H, dn_s, drh_s, red, G1);
    __syncthreads();
    for (int p = tid; p < rows * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const float rr = rz_s[r * H2 + u], z = rz_s[r * H2 + H + u];
      const float hp = t > 0 ? hp_s[p] : 0.0f;
      const float n = n_s[p], dh_tot = dh_s[p], drh = drh_s[p];
      const float dr = drh * hp * rr * (1.0f - rr);
      const float dz = dh_tot * (hp - n) * z * (1.0f - z);
      dzrz_s[u * R + r] = dr;
      dzrz_s[(H + u) * R + r] = dz;
      float* out = dzrz + (row0 + r) * H2 + u;
      out[0] = dr;
      out[H] = dz;
      dh_s[p] = dh_tot * z + drh * rr;
    }
    __syncthreads();
    matvec<R, false, kChunk>(Wrzt, H2, H, dzrz_s, dq_s, red, G2);
    __syncthreads();
  }
}

template <int R>
cudaError_t launch_fwd(const float* zrz, const float* zn, const float* wrz,
                       const float* wh, float* hs, const Dims& dm,
                       cudaStream_t st) {
  const int bytes = gru_fwd_smem_floats(dm.H, R) * (int)sizeof(float);
  cudaError_t err = set_smem((const void*)gru_fwd_kernel<R>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(dm.D * ((dm.B + R - 1) / R));
  gru_fwd_kernel<R><<<grid, kThreads, bytes, st>>>(zrz, zn, wrz, wh, hs, dm);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd(float* dzrz, float* dzn, const float* hs,
                       const float* gout, const float* wrzt,
                       const float* wht, const Dims& dm, cudaStream_t st) {
  const int bytes = gru_bwd_smem_floats(dm.H, R) * (int)sizeof(float);
  cudaError_t err = set_smem((const void*)gru_bwd_kernel<R>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(dm.D * ((dm.B + R - 1) / R));
  gru_bwd_kernel<R><<<grid, kThreads, bytes, st>>>(dzrz, dzn, hs, gout, wrzt,
                                                   wht, dm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward over zrz (T, D, B, 2H), zn (T, D, B, H), wrz (D, H, 2H) and wh
// (D, H, H): hs (T, D, B, H).  One launch.  Returns the cudaError_t of
// the launch.
int bigdl_gru_fwd_f32(const float* zrz, const float* zn, const float* wrz,
                      const float* wh, float* hs, int T, int D, int B, int H,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (gru_rows(H)) {
    case 8: return (int)launch_fwd<8>(zrz, zn, wrz, wh, hs, dm, st);
    case 4: return (int)launch_fwd<4>(zrz, zn, wrz, wh, hs, dm, st);
    case 2: return (int)launch_fwd<2>(zrz, zn, wrz, wh, hs, dm, st);
    case 1: return (int)launch_fwd<1>(zrz, zn, wrz, wh, hs, dm, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Backward: dzrz (T, D, B, 2H), dzn (T, D, B, H) and the r o hprev stack
// rh (T, D, B, H), from the forward's inputs, its hs and the cotangent
// gout (T, D, B, H).  `wrzt` (D * 2H * H floats) and `wht` (D * H * H)
// are scratch.  Five launches on the stream: the two transposes, r and z
// of every step (with rh), n of every step, the serial loop.
int bigdl_gru_bwd_f32(const float* zrz, const float* zn, const float* wrz,
                      const float* wh, const float* hs, const float* gout,
                      float* dzrz, float* dzn, float* rh, float* wrzt,
                      float* wht, int T, int D, int B, int H, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  const int rows = gru_rows(H);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_transpose(wrz, wrzt, D, H, 2 * H, st);
  launch_transpose(wh, wht, D, H, H, st);
  const long long M = (long long)T * B;
  const unsigned mt = (unsigned)((M + kBM - 1) / kBM);
  gates_kernel<false, true><<<dim3(mt, (2 * H + kBN - 1) / kBN, D),
                              kGemmThreads, 0, st>>>(
      zrz, wrz, Stack{hs, nullptr, true}, dzrz, rh, dm, 2 * H);
  gates_kernel<true, false><<<dim3(mt, (H + kBN - 1) / kBN, D), kGemmThreads,
                              0, st>>>(zn, wh, Stack{rh, nullptr, false},
                                       dzn, nullptr, dm, H);
  switch (rows) {
    case 8: return (int)launch_bwd<8>(dzrz, dzn, hs, gout, wrzt, wht, dm, st);
    case 4: return (int)launch_bwd<4>(dzrz, dzn, hs, gout, wrzt, wht, dm, st);
    case 2: return (int)launch_bwd<2>(dzrz, dzn, hs, gout, wrzt, wht, dm, st);
    default:
      return (int)launch_bwd<1>(dzrz, dzn, hs, gout, wrzt, wht, dm, st);
  }
}

// dwrz (D, H, 2H) = sum over t, b of hprev^T . dzrz (the h stack at
// t - 1, zeros at t = 0) and dwh (D, H, H) = sum of rh^T . dzn, in S1 and
// S2 slices of slice1 and slice2 rows (recurrence_dwh.cuh); `part` is
// scratch of max(S1 * 2, S2) * D * H * H floats, used by one product
// after the other.  Four launches.
int bigdl_gru_dwh_f32(const float* hs, const float* rh, const float* dzrz,
                      const float* dzn, float* part, float* dwrz, float* dwh,
                      int T, int D, int B, int H, int S1, long long slice1,
                      int S2, long long slice2, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_dwh(Stack{hs, nullptr, true}, dzrz, part, dwrz,
                   DwhShape{T, D, B, H, 2 * H, slice1}, S1, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dwh(Stack{rh, nullptr, false}, dzn, part, dwh,
                         DwhShape{T, D, B, H, H, slice2}, S2, st);
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
