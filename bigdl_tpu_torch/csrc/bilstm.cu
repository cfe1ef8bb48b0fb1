// Direction-batched LSTM recurrence, forward and backward, fp32, for
// Hopper (sm_90a), and the forward-only LSTM from a given state.
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_bilstm_fwd_call` and
// `_bilstm_bwd_call` (the pair behind `bilstm_recurrence`) and
// `_lstm_scan_kernel` (behind `lstm_scan`).  Contract, as there, over the
// hoisted input projection zx (T, D, B, 4H) and the recurrent weights wht
// (D, H, 4H), D directions (1: Recurrent, 2: BiRecurrent; the kernels
// know nothing of reversal), from h0, c0 (lstm_scan, a truncated run's
// carried state) or h = c = 0:
//   z   = zx[t,d] + h . wht[d]             gates i, f, g, o: the four
//   c'  = sig(f) c + sig(i) tanh(g)        H-wide slices of z, in order
//   h'  = sig(o) tanh(c')                  -> hs[t,d] (and cs[t,d])
// and the backward in reverse time from dh = dc = 0 (a truncated run's
// chunk starts its dc at 0 too: h0 and c0 are constants), with
// hprev/cprev the step t-1 values (h0, c0 or zeros at t = 0) and the
// gates recomputed from zx[t] + hprev . wht:
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
// previous step's h (the backward: dz).
//
// What this design does about it: both serial loops are the cluster
// recurrence of recurrence_cluster.cuh.  One cluster of C blocks per
// (direction, tile of R batch rows) walks all T steps; block k owns units
// [k H / C, (k + 1) H / C) and all four gate columns of each, so c (the
// backward: dc) stays in its shared memory; its slice of wht[d] stays in
// shared memory for all T steps where it fits (128 KB at the classifier's
// width with C = 2), so each step reads wht once a cluster, not once a
// block through L2.  The forward (LstmFwd) exchanges h; the with-c
// forward, the primal forward and lstm_scan are one instantiation, the c
// stack a runtime option, so they take one plan and give the same bits.
// The backward (LstmBwd) exchanges dz, four values a unit, unit-major, so
// a block's slice is one contiguous run; block k reads its units' rows of
// wht[d] in place (dh[u] = sum_j dz[j] wht[d][u][j]), staged in the
// order of the state.  Its seven inputs a unit and a step (the four
// activated gates, c_t, c_{t-1}, gout) are prefetched into the ring; the
// gates come from a parallel tiled product over every step first (they
// depend only on the stored h stack), written into dzx, which the loop
// overwrites with dz unit by unit; c_{t-1} at t = 0 is c0, read through
// the ring's initial-value pointer.  dwht is a tiled product over dzx
// and the h stack (h0 at t = 0) (recurrence_dwh.cuh), split over the
// time*batch axis into
// fixed slices summed in a fixed order.  No atomics: the same bits every
// run.  The TPU kernels' VMEM-resident Wh, `block_t` grid steps and time
// padding exist for their sequential grid and have no counterpart here.
//
// The plan (C, R) is a function of (cell, D, B, H) (ops/_recurrence.py
// mirrors it); H up to the largest whose 16-block cluster of one row fits
// shared memory, in the forward and the backward, is taken, and the
// wrapper refuses a larger H.
//
// What it does not do yet: the product is fp32 FMAs on the CUDA cores
// from shared memory; the serial chain of T steps, each with one cluster
// barrier, sets the time, not the product's operations.

#include "recurrence_cluster.cuh"
#include "recurrence_dwh.cuh"

namespace {

// z = zx + h . wht; c' = sig(f) c + sig(i) tanh(g); h' = sig(o) tanh(c')
struct LstmFwd {
  static constexpr int G = 4, V = 1, E = 4;
  static constexpr bool kReverse = false, kHasC = true, kWeightT = false;
  __host__ __device__ static constexpr In input(int q) { return {0, q, 4, 0}; }
  __device__ static void update(const float* x, const float* z, float& c,
                                float* y) {
    const float i = sigm(x[0] + z[0]);
    const float f = sigm(x[1] + z[1]);
    const float g = tanhf(x[2] + z[2]);
    const float o = sigm(x[3] + z[3]);
    c = f * c + i * g;
    y[0] = o * tanhf(c);
  }
};

// dz of the four gates in reverse time, c the carried dc; x = (i, f, g,
// o activated, c_t, c_{t-1}, gout) from the stacks (gates, cs, gout)
struct LstmBwd {
  static constexpr int G = 1, V = 4, E = 7;
  static constexpr bool kReverse = true, kHasC = true, kWeightT = true;
  __host__ __device__ static constexpr In input(int q) {
    return q < 4 ? In{0, q, 4, 0}
                 : (q == 6 ? In{2, 0, 1, 0} : In{1, 0, 1, q == 5 ? -1 : 0});
  }
  __device__ static void update(const float* x, const float* z, float& c,
                                float* y) {
    const float i = x[0], f = x[1], g = x[2], o = x[3];
    const float tc = tanhf(x[4]);
    const float dh_tot = x[6] + z[0];
    const float dc_tot = c + dh_tot * o * (1.0f - tc * tc);
    y[0] = dc_tot * g * i * (1.0f - i);
    y[1] = dc_tot * x[5] * f * (1.0f - f);
    y[2] = dc_tot * i * (1.0f - g * g);
    y[3] = dh_tot * tc * o * (1.0f - o);
    c = dc_tot * f;
  }
};

// The backward's gates, all steps at once: gates[t,d,b,:] =
// act(zx[t,d,b,:] + hprev[t,d,b,:] . wht[d]), sigmoid on i, f, o and tanh
// on g, hprev h0 (or zeros when null) at t = 0.  Rows m = t * B + b of
// direction blockIdx.z; a tiled product over k < H.
__global__ void __launch_bounds__(kGemmThreads)
    gates_kernel(const float* __restrict__ zx, const float* __restrict__ wht,
                 const float* __restrict__ hs, const float* __restrict__ h0,
                 float* __restrict__ gates, Dims dm) {
  __shared__ __align__(16) float As[kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[kBK][kBN + kPad];
  const int H = dm.H, H4 = 4 * H, d = blockIdx.z, tid = threadIdx.x;
  const long long M = (long long)dm.T * dm.B;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int ty = tid / 16, tx = tid % 16;
  const float* W = wht + (size_t)d * H * H4;
  const Stack hprev{hs, h0, true};
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

}  // namespace

extern "C" {

// Forward over zx (T, D, B, 4H) and wht (D, H, 4H) from h0, c0 (D, B, H),
// or zeros where null: hs (T, D, B, H) and, unless `cs` is null, cs.
// Under the plan of the shape (C = R = 0) or at (C, R).  One launch.
// Returns the cudaError_t of the launch.
int bigdl_lstm_fwd_f32(const float* zx, const float* wht, const float* h0,
                       const float* c0, float* hs, float* cs, int T, int D,
                       int B, int H, int C, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  const Args a{{zx}, wht, h0, c0, hs, cs, dm};
  return (int)launch_planned<LstmFwd>(a, plan_of<LstmFwd>(D, B, H, C, R),
                                      static_cast<cudaStream_t>(stream));
}

// Backward: dzx (T, D, B, 4H) from the forward's zx, wht, hs and cs, its
// initial state h0, c0 (D, B, H) (zeros where null) and the cotangent
// gout (T, D, B, H), under the plan of the shape (C = R = 0) or at (C,
// R).  Two launches on the stream: the gates of every step (into dzx),
// then the serial loop.
int bigdl_lstm_bwd_f32(const float* zx, const float* wht, const float* hs,
                       const float* cs, const float* h0, const float* c0,
                       const float* gout, float* dzx, int T, int D, int B,
                       int H, int C, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, D, B, H};
  if (empty(dm)) return 0;
  const Plan p = plan_of<LstmBwd>(D, B, H, C, R);
  if (p.C == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long M = (long long)T * B;
  const dim3 ggrid((unsigned)((M + kBM - 1) / kBM), (4 * H + kBN - 1) / kBN,
                   D);
  gates_kernel<<<ggrid, kGemmThreads, 0, st>>>(zx, wht, hs, h0, dzx, dm);
  const Args a{{dzx, cs, gout}, wht, nullptr, nullptr, dzx, nullptr, dm,
               nullptr, nullptr, c0};
  return (int)launch_planned<LstmBwd>(a, p, st);
}

// The plan of the forward (bwd = 0) or backward (1) at (D, B, H) into
// out[8]: C, R, RT, KP, S, staged, depth, bytes (C = 0: none fits).
void bigdl_lstm_plan(int bwd, int D, int B, int H, int* out) {
  plan_out(bwd ? plan_of<LstmBwd>(D, B, H) : plan_of<LstmFwd>(D, B, H), out);
}

// dwht (D, H, 4H) = sum over t, b of hprev^T . dzx (recurrence_dwh.cuh),
// hprev the h stack at t - 1 and h0 (or zeros when null) at t = 0, the
// time*batch axis cut into S slices of `slice` rows; `part` is scratch of
// S * D * H * 4H floats.  Two launches: the sliced products, then their
// sum in order.
int bigdl_lstm_dwh_f32(const float* hs, const float* h0, const float* dzx,
                       float* part, float* dwht, int T, int D, int B, int H,
                       int S, long long slice, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const DwhShape sh{T, D, B, H, 4 * H, slice};
  return (int)launch_dwh(Stack{hs, h0, true}, dzx, part, dwht, sh, S,
                         static_cast<cudaStream_t>(stream));
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
