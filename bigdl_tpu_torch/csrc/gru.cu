// Direction-batched GRU recurrence, forward and backward, fp32, for
// Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_gru_fwd_call` and
// `_gru_bwd_call` (the pair behind `gru_recurrence`).  Contract, as
// there, over the hoisted input projections zrz (T, D, B, 2H) and zn
// (T, D, B, H) (biases added) and the recurrent weights wrz (D, H, 2H)
// and wh (D, H, H), D directions, from h0 (D, B, H) (a truncated run's
// carried state) or h = 0 at t = 0:
//   r, z = sig(zrz[t,d] + h . wrz[d])       the two H-wide halves
//   n    = tanh(zn[t,d] + (r o h) . wh[d])
//   h'   = (1 - z) n + z h                  -> hs[t,d]
// and the backward in reverse time from dh = 0 (h0 is a constant), with
// hprev the step t-1 value (h0 or zeros at t = 0) and r, z, n recomputed
// from the h stack:
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
// What this design does about it: both serial loops are two-phase cells
// of the cluster recurrence (recurrence_cluster.cuh).  One cluster of C
// blocks per (direction, tile of R batch rows) walks all T steps; block k
// owns units [k H / C, (k + 1) H / C) and holds its columns of wrz[d] and
// wh[d] (its rows, backward) in shared memory for all T steps where they
// fit, so no step reads a weight through L2.  Forward (GruFwd): phase 0
// is h . wrz, whose update keeps z and exchanges r o h; phase 1 is
// (r o h) . wh, whose update exchanges and stores h'.  Backward (GruBwd),
// in reverse time: phase 0 is dzrz' . wrz^T over the dr, dz that phase 1
// exchanged a step before (t + 1), whose update forms dh_tot and
// exchanges and stores dn; phase 1 is dn . wh^T, whose update exchanges
// and stores dr, dz and keeps dh_tot z + drh r for the next step.  z and
// h (forward, h from h0), dh_tot and the carried dh (backward) are each
// unit's two local values; h0 is also the state phase 0 of step 0 reads.
// The backward's r, z and n depend only on the stored h stack, so a
// parallel pre-pass (recurrence_dwh.cuh) computes them for every step
// first (two tiled products, writing r o hprev beside them) into dzrz and
// dzn, which the loop overwrites unit by unit; its five inputs a unit and
// a step are
// r, z, n, h_{t-1} (h0 at t = 0, through the ring's initial-value
// pointer) and gout.  Both weight gradients are tiled products of
// recurrence_dwh.cuh.  The plan (C, R) is a function of (cell, D, B, H)
// (ops/_recurrence.py mirrors it); H up to the largest whose 16-block
// cluster of one row fits shared memory, forward and backward, is taken,
// and the wrapper refuses a larger H.

#include "recurrence_cluster.cuh"
#include "recurrence_dwh.cuh"

namespace {

// phase 0: r, z = sig(zrz + h . wrz[d]), exchanging r o h; phase 1:
// n = tanh(zn + (r o h) . wh[d]), h' = (1 - z) n + z h, exchanged.  Local
// values z and h (h from h0); x = (zr, zz, zn) from the stacks (zrz, zn).
struct GruFwd {
  static constexpr int E = 3, L = 2;
  static constexpr int kLocalH0 = 1;   // h starts from h0
  static constexpr bool kReverse = false, kHasC = false;
  __host__ __device__ static constexpr In input(int q) {
    return q < 2 ? In{0, q, 2, 0} : In{1, 0, 1, 0};
  }
  struct P0 {
    static constexpr int G = 2, V = 1;
    static constexpr bool kWeightT = false;
    __device__ static void update(const float* x, const float* z, float* loc,
                                  float* y) {
      const float r = sigm(x[0] + z[0]);
      loc[0] = sigm(x[1] + z[1]);
      y[0] = r * loc[1];
    }
  };
  struct P1 {
    static constexpr int G = 1, V = 1;
    static constexpr bool kWeightT = false;
    __device__ static void update(const float* x, const float* z, float* loc,
                                  float* y) {
      const float n = tanhf(x[2] + z[0]);
      loc[1] = (1.0f - loc[0]) * n + loc[0] * loc[1];
      y[0] = loc[1];
    }
  };
};

// In reverse time from dh = 0; x = (r, z, n, h_{t-1}, gout) from the
// stacks (dzrz, dzn, hs, gout).  Phase 0: dq = dzrz' . wrz[d]^T (dzrz' of
// step t + 1), dh_tot = gout + (dh + dq), dn exchanged; phase 1: drh =
// dn . wh[d]^T, dr and dz exchanged.  Local values dh_tot and dh.
struct GruBwd {
  static constexpr int E = 5, L = 2;
  static constexpr int kLocalH0 = -1;
  static constexpr bool kReverse = true, kHasC = false;
  __host__ __device__ static constexpr In input(int q) {
    return q < 2 ? In{0, q, 2, 0}
                 : (q == 2 ? In{1, 0, 1, 0}
                           : (q == 3 ? In{2, 0, 1, -1} : In{3, 0, 1, 0}));
  }
  struct P0 {
    static constexpr int G = 1, V = 1;
    static constexpr bool kWeightT = true;
    __device__ static void update(const float* x, const float* z, float* loc,
                                  float* y) {
      const float dh_tot = x[4] + (loc[1] + z[0]);
      loc[0] = dh_tot;
      y[0] = dh_tot * (1.0f - x[1]) * (1.0f - x[2] * x[2]);
    }
  };
  struct P1 {
    static constexpr int G = 1, V = 2;
    static constexpr bool kWeightT = true;
    __device__ static void update(const float* x, const float* z, float* loc,
                                  float* y) {
      const float r = x[0], zz = x[1], hp = x[3], dh_tot = loc[0];
      const float drh = z[0];
      y[0] = drh * hp * r * (1.0f - r);
      y[1] = dh_tot * (hp - x[2]) * zz * (1.0f - zz);
      loc[1] = dh_tot * zz + drh * r;
    }
  };
};

}  // namespace

extern "C" {

// Forward over zrz (T, D, B, 2H), zn (T, D, B, H), wrz (D, H, 2H) and wh
// (D, H, H) from h0 (D, B, H), or zeros when null: hs (T, D, B, H), under
// the plan of the shape (C = R = 0) or at (C, R).  One launch.  Returns
// the cudaError_t of the launch.
int bigdl_gru_fwd_f32(const float* zrz, const float* zn, const float* wrz,
                      const float* wh, const float* h0, float* hs, int T,
                      int D, int B, int H, int C, int R, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  const Args a{{zrz, zn}, wrz, h0, nullptr, hs, nullptr, dm, wh, nullptr};
  return (int)launch_planned<GruFwd>(a, plan_of<GruFwd>(D, B, H, C, R),
                                     static_cast<cudaStream_t>(stream));
}

// Backward: dzrz (T, D, B, 2H), dzn (T, D, B, H) and the r o hprev stack
// rh (T, D, B, H), from the forward's inputs, its hs, its h0 (zeros when
// null) and the cotangent gout (T, D, B, H), under the plan of the shape
// (C = R = 0) or at (C, R).  Three launches on the stream: r and z of
// every step (with rh), n of every step, the serial loop.
int bigdl_gru_bwd_f32(const float* zrz, const float* zn, const float* wrz,
                      const float* wh, const float* hs, const float* h0,
                      const float* gout, float* dzrz, float* dzn, float* rh,
                      int T, int D, int B, int H, int C, int R, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  const Plan p = plan_of<GruBwd>(D, B, H, C, R);
  if (p.C == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_prepass<kSigmoid, true>(zrz, wrz, Stack{hs, h0, true}, dzrz, rh,
                                 DwhShape{T, D, B, H, 2 * H, 0}, st);
  launch_prepass<kTanh, false>(zn, wh, Stack{rh, nullptr, false}, dzn,
                               nullptr, DwhShape{T, D, B, H, H, 0}, st);
  const Args a{{dzrz, dzn, hs, gout}, wrz, nullptr, nullptr, dzrz, nullptr,
               dm, wh, dzn, h0};
  return (int)launch_planned<GruBwd>(a, p, st);
}

// The plan of the forward (bwd = 0) or backward (1) at (D, B, H) into
// out[8]: C, R, RT, KP, S, staged, depth, bytes (C = 0: none fits).
void bigdl_gru_plan(int bwd, int D, int B, int H, int* out) {
  plan_out(bwd ? plan_of<GruBwd>(D, B, H) : plan_of<GruFwd>(D, B, H), out);
}

// dwrz (D, H, 2H) = sum over t, b of hprev^T . dzrz (the h stack at
// t - 1, h0 or zeros when null at t = 0) and dwh (D, H, H) = sum of rh^T
// . dzn, in S1 and S2 slices of slice1 and slice2 rows
// (recurrence_dwh.cuh); `part` is scratch of max(S1 * 2, S2) * D * H * H
// floats, used by one product after the other.  Four launches.
int bigdl_gru_dwh_f32(const float* hs, const float* h0, const float* rh,
                      const float* dzrz, const float* dzn, float* part,
                      float* dwrz, float* dwh, int T, int D, int B, int H,
                      int S1, long long slice1, int S2, long long slice2,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = launch_dwh(Stack{hs, h0, true}, dzrz, part, dwrz,
                   DwhShape{T, D, B, H, 2 * H, slice1}, S1, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dwh(Stack{rh, nullptr, false}, dzn, part, dwh,
                         DwhShape{T, D, B, H, H, slice2}, S2, st);
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
