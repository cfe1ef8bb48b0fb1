// Forward-only, single-direction LSTM from a given state, fp32, for
// Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_lstm_scan_kernel` (the
// kernel behind `lstm_scan`).  Contract, as there, over the hoisted input
// projection zx (T, B, 4H) (bias added) and the recurrent weight wht
// (H, 4H), from the state h0, c0 (B, H):
//   z   = zx[t] + h . wht                  gates i, f, g, o: the four
//   c'  = sig(f) c + sig(i) tanh(g)        H-wide slices of z, in order
//   h'  = sig(o) tanh(c')                  -> hs[t]
// No gradient: c stays on chip and is never written.  sig(x) =
// 1/(1+expf(-x)), tanhf: no fast math.
//
// What bounds it on this card: at the LSTM classifier's validation
// shapes (T 500, B 128, H 128) the recurrent product is 8.4 GFLOP (0.125
// ms at the fp32 peak) against ~0.2 GB moved (0.06 ms), but the serial
// chain of T steps, each needing the whole of wht (256 KB, more than a
// block's 227 KB of shared memory) and the previous step's h, is what
// sets the time.
//
// What this design does about it: the cluster recurrence of
// recurrence_cluster.cuh at D = 1.  One cluster of C blocks per tile of
// R batch rows walks all T steps; block k owns units [k H / C, (k + 1) H
// / C) and all four gate columns of each, so c stays in its shared
// memory and the gate arithmetic never leaves it; its H x 4(H / C) slice
// of wht stays in shared memory for all T steps where it fits (32 KB at
// (500, 128, 128) with C = 8: the whole 256 KB fits no block), so each
// step reads wht once a cluster, not once a block.  The new h slice goes
// to every block of the cluster through distributed shared memory before
// the step's one cluster barrier, and each lane prefetches its own zx
// values several steps ahead into a cp.async ring.  The product sums runs
// of 32 terms from zero, then runs of those: at the largest H one fp32
// chain of H roundings would leave h further from the exact value than
// the blocked plain version.  The plan (C, R) is a function of (B, H)
// (ops/_recurrence.py mirrors it); H up to the largest whose 16-block
// cluster at one row fits shared memory is taken, and the wrapper refuses
// a larger H.  The TPU kernel's grid of T sequential steps, with h and c
// carried in VMEM scratch, has no counterpart here.

#include "recurrence_cluster.cuh"

namespace {

// z = zx + h . wht; c' = sig(f) c + sig(i) tanh(g); h' = sig(o) tanh(c')
struct LstmFwd {
  static constexpr int G = 4, kIn = 1;
  static constexpr bool kReverse = false, kHasC = true, kWeightT = false;
  __device__ static float update(const float* x, const float* z, float& c) {
    const float i = sigm(x[0] + z[0]);
    const float f = sigm(x[1] + z[1]);
    const float g = tanhf(x[2] + z[2]);
    const float o = sigm(x[3] + z[3]);
    c = f * c + i * g;
    return o * tanhf(c);
  }
};

// The plan of the shape, or with C > 0 the plan at (C, R) (C = 0 in it
// when that does not fit): recurrence_plans.py times them all.
Plan scan_plan(int B, int H, int C = 0, int R = 0) {
  return C > 0 ? plan_at(LstmFwd::G, LstmFwd::kIn, LstmFwd::kHasC, H, R, C)
               : make_plan(LstmFwd::G, LstmFwd::kIn, LstmFwd::kHasC, 1, B,
                           H);
}

}  // namespace

extern "C" {

// hs (T, B, H) over zx (T, B, 4H) and wht (H, 4H) from h0, c0 (B, H),
// under the plan of the shape (C = R = 0) or at (C, R).  One launch.
// Returns the cudaError_t of the launch.
int bigdl_lstm_scan_f32(const float* zx, const float* wht, const float* h0,
                        const float* c0, float* hs, int T, int B, int H,
                        int C, int R, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, 1, B, H};
  if (empty(dm)) return 0;
  const Args a{{zx, nullptr}, wht, h0, c0, hs, dm};
  return (int)launch_planned<LstmFwd>(a, scan_plan(B, H, C, R),
                                      static_cast<cudaStream_t>(stream));
}

// The plan at (B, H) into out[8]: C, R, RT, KP, S, staged, depth, bytes
// (C = 0: none fits).
void bigdl_lstm_scan_plan(int B, int H, int* out) {
  const Plan p = scan_plan(B, H);
  const int v[8] = {p.C, p.R, p.RT, p.KP, p.S, p.staged, p.depth, p.bytes};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
