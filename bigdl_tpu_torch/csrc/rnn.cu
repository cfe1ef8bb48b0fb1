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
// What this design does about it: the cluster recurrence of
// recurrence_cluster.cuh.  One cluster of C blocks per (direction, tile
// of R batch rows) walks all T steps; block k owns hidden units [k H /
// C, (k + 1) H / C), holds its columns of wht[d] (forward) or its rows
// (backward: dh[u] = sum_j dz[j] wht[u, j] needs row u, so no transpose
// launch) in shared memory for all T steps when they fit, and sends its
// new h (dz) slice to every block of the cluster through distributed
// shared memory before the step's one cluster barrier.  Each lane
// prefetches its own zx (gout and h_t) values several steps ahead into a
// cp.async ring, so no step waits on device memory.  The plan (C, R) is
// a function of (D, B, H) (ops/_recurrence.py mirrors it): C = 1 at
// SimpleRNN's width, where one block's barrier is cheaper than a
// cluster's.  The product sums runs of 32 terms from zero, then runs of
// those: at H = 14,528 one fp32 chain of H roundings leaves h about ten
// times further from the exact sum than the blocked plain version.

#include "recurrence_cluster.cuh"
#include "recurrence_dwh.cuh"

namespace {

// h' = tanh(zx + h . wht[d])
struct RnnFwd {
  static constexpr int G = 1, V = 1, E = 1;
  static constexpr bool kReverse = false, kHasC = false, kWeightT = false;
  __host__ __device__ static constexpr In input(int) { return {0, 0, 1, 0}; }
  __device__ static void update(const float* x, const float* z, float&,
                                float* y) {
    y[0] = tanhf(x[0] + z[0]);
  }
};

// dz = (gout + dz' . wht[d]^T) (1 - h^2), in reverse time; x = (gout, h)
struct RnnBwd {
  static constexpr int G = 1, V = 1, E = 2;
  static constexpr bool kReverse = true, kHasC = false, kWeightT = true;
  __host__ __device__ static constexpr In input(int q) { return {q, 0, 1, 0}; }
  __device__ static void update(const float* x, const float* z, float&,
                                float* y) {
    y[0] = (x[0] + z[0]) * (1.0f - x[1] * x[1]);
  }
};

}  // namespace

extern "C" {

// Forward over zx (T, D, B, H) and wht (D, H, H) from h0 (D, B, H), or
// zeros when h0 is null: hs (T, D, B, H), under the plan of the shape
// (C = R = 0) or at (C, R).  One launch.  Returns the cudaError_t of the
// launch.
int bigdl_rnn_fwd_f32(const float* zx, const float* wht, const float* h0,
                      float* hs, int T, int D, int B, int H, int C, int R,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  const Args a{{zx}, wht, h0, nullptr, hs, nullptr, dm};
  return (int)launch_planned<RnnFwd>(a, plan_of<RnnFwd>(D, B, H, C, R),
                                     static_cast<cudaStream_t>(stream));
}

// Backward: dzx (T, D, B, H) from wht, the forward's hs and the cotangent
// gout (T, D, B, H), under the plan as the forward's.  One launch.
int bigdl_rnn_bwd_f32(const float* wht, const float* hs, const float* gout,
                      float* dzx, int T, int D, int B, int H, int C, int R,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  const Args a{{gout, hs}, wht, nullptr, nullptr, dzx, nullptr, dm};
  return (int)launch_planned<RnnBwd>(a, plan_of<RnnBwd>(D, B, H, C, R),
                                     static_cast<cudaStream_t>(stream));
}

// The plan of the forward (bwd = 0) or backward (1) at (D, B, H) into
// out[8]: C, R, RT, KP, S, staged, depth, bytes (C = 0: none fits).
void bigdl_rnn_plan(int bwd, int D, int B, int H, int* out) {
  plan_out(bwd ? plan_of<RnnBwd>(D, B, H) : plan_of<RnnFwd>(D, B, H), out);
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
