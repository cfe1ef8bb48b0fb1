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
// What this design does about it: one block per (direction, tile of R
// batch rows) walks all T steps in a loop, so no block waits for
// another (batch rows never interact) and no step needs a grid-wide
// barrier.  Its rows' h and c stay in shared memory; each step it reads
// wht[d] through L2 (512 KB for both directions stays resident in the
// 50 MB L2), R rows at a time, while cp.async stages the step's zx
// rows into shared memory under the product.  The backward first
// recomputes every step's gates in one parallel tiled product (they
// depend only on the stored h stack), so its serial loop carries only
// dz . wht^T; dwht is a second tiled product over dzx and the h stack,
// split over the time*batch axis into fixed slices summed in a fixed
// order: no atomics, the same bits every run.  The TPU kernel's VMEM-
// resident Wh, `block_t` grid steps and time padding exist for its
// sequential grid and have no counterpart here.
//
// R is 8 up to H = 558 and falls to 4, 2, 1 as H grows (the row rule of
// recurrence_block.cuh), up to H = 4,470; the wrapper refuses a larger H.

#include "recurrence_block.cuh"
#include "recurrence_dwh.cuh"

namespace {

// Shared memory of the forward block at R rows, in floats.
__host__ __device__ inline int fwd_smem_floats(int H, int R) {
  const int G = groups(H, 4 * H);
  return R * 10 * H + (G > 1 ? G * R * 4 * H : 0);
}

// Shared memory of the backward's serial block at R rows, in floats.
__host__ __device__ inline int bwd_smem_floats(int H, int R) {
  const int G = groups(4 * H, H);
  return R * 13 * H + (G > 1 ? G * R * H : 0);
}

// The batch rows of a block at H: the row rule over both blocks.
inline int lstm_rows(int H) {
  return rows_for([H](int r) {
    const int f = fwd_smem_floats(H, r), b = bwd_smem_floats(H, r);
    return 4 * (f > b ? f : b);
  });
}

template <int R, bool WITH_C>
__global__ void __launch_bounds__(kThreads)
    lstm_fwd_kernel(const float* __restrict__ zx,
                    const float* __restrict__ wht, float* __restrict__ hs,
                    float* __restrict__ cs, Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = dm.H, H4 = 4 * H, tid = threadIdx.x;
  const int tiles = (dm.B + R - 1) / R;
  const int d = blockIdx.x / tiles, b0 = (blockIdx.x % tiles) * R;
  const int rows = min(R, dm.B - b0);
  float* h_s = smem;              // [H][R], rows past `rows` stay 0
  float* c_s = h_s + H * R;       // [rows][H]
  float* z_s = c_s + H * R;       // [R][4H]: h . wht
  float* x_s = z_s + H4 * R;      // [rows][4H]: this step's zx rows
  float* red = x_s + H4 * R;      // [G][R][4H]
  const int G = groups(H, H4);
  for (int e = tid; e < 2 * H * R; e += kThreads) smem[e] = 0.0f;
  const float* W = wht + (size_t)d * H * H4;
  __syncthreads();
  for (int t = 0; t < dm.T; ++t) {
    const size_t row0 = ((size_t)t * dm.D + d) * dm.B + b0;
    const float* src = zx + row0 * H4;
    for (int e = tid; e < rows * H4; e += kThreads)
      cp_async4(x_s + e, src + e);
    matvec<R>(W, H, H4, h_s, z_s, red, G);
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
      h_s[u * R + r] = h;
      const size_t at = (row0 + r) * H + u;
      hs[at] = h;
      if (WITH_C) cs[at] = c;
    }
    __syncthreads();
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
  const Stack hprev{hs, nullptr, true};
  // loaders: A rows (m, 4 consecutive k), B rows (k, 4 consecutive n)
  const int am = tid / 4, ak = (tid % 4) * 4;
  const int bk = tid / 16, bn = (tid % 16) * 4;
  const float* arow =
      m0 + am < M ? stack_row(hprev, dm.D, dm.B, H, d, m0 + am) : nullptr;
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
// block that staged them.  The grid is small (32 blocks at the
// classifier's shape) and one block an SM is enough; saying so (the 1)
// matters: without it ptxas gave the 8-row block 32 registers and
// spills, and the loop took 1.5x as long.
template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_bwd_kernel(float* __restrict__ dzx, const float* __restrict__ cs,
                    const float* __restrict__ gout,
                    const float* __restrict__ wh, Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = dm.H, H4 = 4 * H, tid = threadIdx.x;
  const int tiles = (dm.B + R - 1) / R;
  const int d = blockIdx.x / tiles, b0 = (blockIdx.x % tiles) * R;
  const int rows = min(R, dm.B - b0);
  float* dz_s = smem;              // [4H][R]: dz of step t + 1
  float* dh_s = dz_s + H4 * R;     // [R][H]: dz . wht^T
  float* dc_s = dh_s + H * R;      // [rows][H]
  float* g_s = dc_s + H * R;       // [rows][4H]: step t's gates
  float* c_s = g_s + H4 * R;       // [rows][H]: c_t
  float* cp_s = c_s + H * R;       // [rows][H]: c_{t-1}
  float* go_s = cp_s + H * R;      // [rows][H]: gout[t]
  float* red = go_s + H * R;       // [G][R][H]
  const int G = groups(H4, H);
  for (int e = tid; e < 6 * H * R; e += kThreads) smem[e] = 0.0f;
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
    matvec<R>(W, H4, H, dz_s, dh_s, red, G);
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
        dz_s[(q * H + u) * R + r] = dz[q];
      }
      dc_s[p] = dc_tot * f;
    }
    __syncthreads();
  }
}

template <int R>
cudaError_t launch_fwd(const float* zx, const float* wht, float* hs,
                       float* cs, const Dims& dm, cudaStream_t st) {
  const int bytes = fwd_smem_floats(dm.H, R) * (int)sizeof(float);
  const dim3 grid(dm.D * ((dm.B + R - 1) / R));
  cudaError_t err;
  if (cs != nullptr) {
    err = set_smem((const void*)lstm_fwd_kernel<R, true>, bytes);
    if (err != cudaSuccess) return err;
    lstm_fwd_kernel<R, true><<<grid, kThreads, bytes, st>>>(zx, wht, hs, cs,
                                                            dm);
  } else {
    err = set_smem((const void*)lstm_fwd_kernel<R, false>, bytes);
    if (err != cudaSuccess) return err;
    lstm_fwd_kernel<R, false><<<grid, kThreads, bytes, st>>>(zx, wht, hs,
                                                             nullptr, dm);
  }
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd(float* dzx, const float* cs, const float* gout,
                       const float* wh, const Dims& dm, cudaStream_t st) {
  const int bytes = bwd_smem_floats(dm.H, R) * (int)sizeof(float);
  cudaError_t err = set_smem((const void*)lstm_bwd_kernel<R>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(dm.D * ((dm.B + R - 1) / R));
  lstm_bwd_kernel<R><<<grid, kThreads, bytes, st>>>(dzx, cs, gout, wh, dm);
  return cudaGetLastError();
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
  switch (lstm_rows(H)) {
    case 8: return (int)launch_fwd<8>(zx, wht, hs, cs, dm, st);
    case 4: return (int)launch_fwd<4>(zx, wht, hs, cs, dm, st);
    case 2: return (int)launch_fwd<2>(zx, wht, hs, cs, dm, st);
    case 1: return (int)launch_fwd<1>(zx, wht, hs, cs, dm, st);
  }
  return (int)cudaErrorInvalidValue;
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
  const int rows = lstm_rows(H);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_transpose(wht, wh, D, H, 4 * H, st);
  const long long M = (long long)T * B;
  const dim3 ggrid((unsigned)((M + kBM - 1) / kBM), (4 * H + kBN - 1) / kBN,
                   D);
  gates_kernel<<<ggrid, kGemmThreads, 0, st>>>(zx, wht, hs, dzx, dm);
  switch (rows) {
    case 8: return (int)launch_bwd<8>(dzx, cs, gout, wh, dm, st);
    case 4: return (int)launch_bwd<4>(dzx, cs, gout, wh, dm, st);
    case 2: return (int)launch_bwd<2>(dzx, cs, gout, wh, dm, st);
    default: return (int)launch_bwd<1>(dzx, cs, gout, wh, dm, st);
  }
}

// dwht (D, H, 4H) = sum over t, b of hprev^T . dzx (recurrence_dwh.cuh),
// the time*batch axis cut into S slices of `slice` rows; `part` is
// scratch of S * D * H * 4H floats.  Two launches: the sliced products,
// then their sum in order.
int bigdl_lstm_dwh_f32(const float* hs, const float* dzx, float* part,
                       float* dwht, int T, int D, int B, int H, int S,
                       long long slice, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const DwhShape sh{T, D, B, H, 4 * H, slice};
  return (int)launch_dwh(Stack{hs, nullptr, true}, dzx, part, dwht, sh, S,
                         static_cast<cudaStream_t>(stream));
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
