// Direction-batched tanh-RNN recurrence, forward and backward, fp32, for
// Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_rnn_fwd_call` and
// `_rnn_bwd_call` (the pair behind `rnn_recurrence`).  Contract, as
// there, over the hoisted input projection zx (T, D, B, H) (both biases
// added) and the recurrent weights wht (D, H, H), D directions, from the
// initial state h0 (D, B, H) or zeros (the JAX kernel starts from zeros;
// h0 carries a truncated run's state from one chunk to the next):
//   h'  = tanh(zx[t,d] + h . wht[d])        -> hs[t,d]
// and the backward in reverse time from dh = 0, needing no recompute:
//   dz  = (gout[t] + dh) (1 - h_t^2)        -> dzx[t]
//   dh  = dz . wht[d]^T
//   dwht[d] = sum_t hprev^T . dz            (recurrence_dwh.cuh; hprev is
//                                            h0 or zeros at t = 0)
// tanhf: no fast math.
//
// What bounds it on this card: at SimpleRNN's width (T 8, B 4, H 40) a
// call is a few microseconds of work and the launch and the serial chain
// of T dependent steps set its time; at (500, 2, 128, 128) the products
// are 4.2 GFLOP each way (0.06 ms at the fp32 peak) against ~0.1 GB moved,
// and again the chain of T steps, each needing the previous step's h,
// sets the time.
//
// What this design does about it: bilstm.cu's block.  One block per
// (direction, tile of R batch rows) walks all T steps with its rows' h in
// shared memory, so no step needs a barrier across blocks; the step's zx
// rows are staged by cp.async under the product.  wht[d] (H x H) is
// staged into shared memory once when it fits beside the state (H <= 229
// at 8 rows: 6.4 KB at SimpleRNN's H 40) and read through L2 above that.
// The backward's serial loop carries only dz . wht^T, from wht
// transposed once.  R follows the row rule of recurrence_block.cuh.

#include "recurrence_block.cuh"
#include "recurrence_dwh.cuh"

namespace {

// each run of kChunk products summed from zero, then added (matvec)
constexpr int kChunk = 32;

// Shared memory of the forward block at R rows without wht, in floats.
__host__ __device__ inline int rnn_fwd_smem_floats(int H, int R) {
  const int G = groups(H, H);
  return R * 3 * H + (G > 1 ? G * R * H : 0);
}

// Shared memory of the backward's serial block at R rows without wht^T.
__host__ __device__ inline int rnn_bwd_smem_floats(int H, int R) {
  const int G = groups(H, H);
  return R * 4 * H + (G > 1 ? G * R * H : 0);
}

inline int rnn_rows(int H) {
  return rows_for([H](int r) {
    const int f = rnn_fwd_smem_floats(H, r), b = rnn_bwd_smem_floats(H, r);
    return 4 * (f > b ? f : b);
  });
}

// The block's bytes at `base` floats of state, with wht[d] staged when it
// fits; `staged` says whether it is.
inline int with_weight(int base, int H, bool* staged) {
  const long long all = 4LL * (base + (long long)H * H);
  *staged = all <= kMaxSmem;
  return *staged ? (int)all : 4 * base;
}

// Copies W (n floats) into shared memory at `w_s`; the caller syncs.
__device__ __forceinline__ void stage_weight(float* w_s, const float* W,
                                             int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) cp_async4(w_s + e, W + e);
  cp_async_wait_all();
}

template <int R, bool W_SHARED>
__global__ void __launch_bounds__(kThreads)
    rnn_fwd_kernel(const float* __restrict__ zx,
                   const float* __restrict__ wht,
                   const float* __restrict__ h0, float* __restrict__ hs,
                   Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = dm.H, tid = threadIdx.x;
  const int tiles = (dm.B + R - 1) / R;
  const int d = blockIdx.x / tiles, b0 = (blockIdx.x % tiles) * R;
  const int rows = min(R, dm.B - b0);
  const int G = groups(H, H);
  float* h_s = smem;              // [H][R], rows past `rows` stay 0
  float* z_s = h_s + H * R;       // [R][H]: h . wht
  float* x_s = z_s + H * R;       // [rows][H]: this step's zx rows
  float* red = x_s + H * R;       // [G][R][H]
  float* w_s = red + (G > 1 ? G * R * H : 0);   // [H][H] when staged
  const float* W = wht + (size_t)d * H * H;
  for (int e = tid; e < H * R; e += kThreads) {
    const int u = e / R, r = e - u * R;
    h_s[e] = (h0 != nullptr && r < rows)
                 ? h0[((size_t)d * dm.B + b0 + r) * H + u] : 0.0f;
  }
  if (W_SHARED) {
    stage_weight(w_s, W, H * H);
    W = w_s;
  }
  __syncthreads();
  for (int t = 0; t < dm.T; ++t) {
    const size_t row0 = ((size_t)t * dm.D + d) * dm.B + b0;
    const float* src = zx + row0 * H;
    for (int e = tid; e < rows * H; e += kThreads)
      cp_async4(x_s + e, src + e);
    matvec<R, W_SHARED, kChunk>(W, H, H, h_s, z_s, red, G);
    cp_async_wait_all();
    __syncthreads();
    for (int p = tid; p < rows * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const float h = tanhf(x_s[p] + z_s[p]);
      h_s[u * R + r] = h;
      hs[(row0 + r) * H + u] = h;
    }
    __syncthreads();
  }
}

// The serial backward: one block per (direction, row tile) in reverse
// time.  dzx[t] = (gout[t] + dh) (1 - h_t^2), dh = dz . wht^T.
template <int R, bool W_SHARED>
__global__ void __launch_bounds__(kThreads)
    rnn_bwd_kernel(const float* __restrict__ hs,
                   const float* __restrict__ gout,
                   const float* __restrict__ wh, float* __restrict__ dzx,
                   Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = dm.H, tid = threadIdx.x;
  const int tiles = (dm.B + R - 1) / R;
  const int d = blockIdx.x / tiles, b0 = (blockIdx.x % tiles) * R;
  const int rows = min(R, dm.B - b0);
  const int G = groups(H, H);
  float* dz_s = smem;              // [H][R]: dz of step t + 1
  float* dh_s = dz_s + H * R;      // [R][H]: dz . wht^T
  float* g_s = dh_s + H * R;       // [rows][H]: gout[t]
  float* h_s = g_s + H * R;        // [rows][H]: h_t
  float* red = h_s + H * R;        // [G][R][H]
  float* w_s = red + (G > 1 ? G * R * H : 0);   // [H][H] when staged
  const float* W = wh + (size_t)d * H * H;
  for (int e = tid; e < H * R; e += kThreads) dz_s[e] = 0.0f;
  if (W_SHARED) {
    stage_weight(w_s, W, H * H);
    W = w_s;
  }
  __syncthreads();
  for (int t = dm.T - 1; t >= 0; --t) {
    const size_t row0 = ((size_t)t * dm.D + d) * dm.B + b0;
    for (int e = tid; e < rows * H; e += kThreads) {
      cp_async4(g_s + e, gout + row0 * H + e);
      cp_async4(h_s + e, hs + row0 * H + e);
    }
    matvec<R, W_SHARED, kChunk>(W, H, H, dz_s, dh_s, red, G);
    cp_async_wait_all();
    __syncthreads();
    for (int p = tid; p < rows * H; p += kThreads) {
      const int r = p / H, u = p - r * H;
      const float h = h_s[p];
      const float dz = (g_s[p] + dh_s[p]) * (1.0f - h * h);
      dzx[(row0 + r) * H + u] = dz;
      dz_s[u * R + r] = dz;
    }
    __syncthreads();
  }
}

template <int R>
cudaError_t launch_fwd(const float* zx, const float* wht, const float* h0,
                       float* hs, const Dims& dm, cudaStream_t st) {
  bool staged;
  const int bytes = with_weight(rnn_fwd_smem_floats(dm.H, R), dm.H, &staged);
  const dim3 grid(dm.D * ((dm.B + R - 1) / R));
  if (staged) {
    cudaError_t err = set_smem((const void*)rnn_fwd_kernel<R, true>, bytes);
    if (err != cudaSuccess) return err;
    rnn_fwd_kernel<R, true><<<grid, kThreads, bytes, st>>>(zx, wht, h0, hs,
                                                           dm);
  } else {
    cudaError_t err = set_smem((const void*)rnn_fwd_kernel<R, false>, bytes);
    if (err != cudaSuccess) return err;
    rnn_fwd_kernel<R, false><<<grid, kThreads, bytes, st>>>(zx, wht, h0, hs,
                                                            dm);
  }
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_bwd(const float* hs, const float* gout, const float* wh,
                       float* dzx, const Dims& dm, cudaStream_t st) {
  bool staged;
  const int bytes = with_weight(rnn_bwd_smem_floats(dm.H, R), dm.H, &staged);
  const dim3 grid(dm.D * ((dm.B + R - 1) / R));
  if (staged) {
    cudaError_t err = set_smem((const void*)rnn_bwd_kernel<R, true>, bytes);
    if (err != cudaSuccess) return err;
    rnn_bwd_kernel<R, true><<<grid, kThreads, bytes, st>>>(hs, gout, wh, dzx,
                                                           dm);
  } else {
    cudaError_t err = set_smem((const void*)rnn_bwd_kernel<R, false>, bytes);
    if (err != cudaSuccess) return err;
    rnn_bwd_kernel<R, false><<<grid, kThreads, bytes, st>>>(hs, gout, wh,
                                                            dzx, dm);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward over zx (T, D, B, H) and wht (D, H, H) from h0 (D, B, H), or
// zeros when h0 is null: hs (T, D, B, H).  One launch.  Returns the
// cudaError_t of the launch.
int bigdl_rnn_fwd_f32(const float* zx, const float* wht, const float* h0,
                      float* hs, int T, int D, int B, int H, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rnn_rows(H)) {
    case 8: return (int)launch_fwd<8>(zx, wht, h0, hs, dm, st);
    case 4: return (int)launch_fwd<4>(zx, wht, h0, hs, dm, st);
    case 2: return (int)launch_fwd<2>(zx, wht, h0, hs, dm, st);
    case 1: return (int)launch_fwd<1>(zx, wht, h0, hs, dm, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Backward: dzx (T, D, B, H) from wht, the forward's hs and the cotangent
// gout (T, D, B, H).  `wh` is scratch of D * H * H floats.  Two launches:
// wht^T, the serial loop.
int bigdl_rnn_bwd_f32(const float* wht, const float* hs, const float* gout,
                      float* dzx, float* wh, int T, int D, int B, int H,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  const int rows = rnn_rows(H);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_transpose(wht, wh, D, H, H, st);
  switch (rows) {
    case 8: return (int)launch_bwd<8>(hs, gout, wh, dzx, dm, st);
    case 4: return (int)launch_bwd<4>(hs, gout, wh, dzx, dm, st);
    case 2: return (int)launch_bwd<2>(hs, gout, wh, dzx, dm, st);
    default: return (int)launch_bwd<1>(hs, gout, wh, dzx, dm, st);
  }
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
