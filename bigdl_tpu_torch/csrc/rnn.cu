// Direction-batched RNN recurrence under an element-wise activation act,
// forward and backward, for Hopper (sm_90a): an f32 form and a bf16-weight
// form.
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_rnn_fwd_call` and
// `_rnn_bwd_call` (the pair behind `rnn_recurrence`, whose act is tanh)
// and the JAX package's lax.scan of an RnnCell with any other element-wise
// activation.  Contract over the hoisted input projection zx (T, D, B, H)
// (both biases added) and the recurrent weights wht (D, H, H), D
// directions, from the initial state h0 (D, B, H) or zeros (the JAX
// kernel starts from zeros; h0 carries a truncated run's state from one
// chunk to the next):
//   pre = zx[t,d] + h . wht[d],  h' = act(pre)    -> hs[t,d]
// and the backward in reverse time from dh = 0:
//   dz  = (gout[t] + dh) act'(pre_t)              -> dzx[t]
//   dh  = dz . wht[d]^T
//   dwht[d] = sum_t hprev^T . dz            (recurrence_dwh.cuh; hprev is
//                                            h0 or zeros at t = 0)
// act is one of the twenty kinds of `act_fwd` (ops/_activation.py lists
// them in order of their codes), with up to three parameters; its
// derivative is the JAX package's, kinks included (a clip's bound takes
// 1/2, abs at 0 takes 1).  tanh's derivative is 1 - h^2, from the stored
// h stack, with no recompute; every other kind's is a function of pre,
// which a parallel pre-pass recomputes for every step at once (a tiled
// product over the h stack read at t - 1, h0 at t = 0, into dzx, which
// the loop overwrites unit by unit).  tanhf, expf, ...: no fast math.
//
// The bf16-weight form (rnn_bf16.cu, on the cells of rnn_cells.cuh;
// `Recurrent(RnnCell)` under a reduced dtype policy;
// the JAX kernels on a bf16 wht, pallas_kernels.py:912 and :935): wht
// bf16, held as bf16 in shared memory (half the f32 slice, so its plan is
// its own, `bigdl_rnn_plan_bf16`; the largest H is the f32 form's, whose
// plan reads the weight through L2).  pre = zx + bf16(h) . wht and,
// backward, dh = bf16(dz) . wht^T: the state is rounded to bf16 only where
// it meets the weight, the exact products summed in f32
// (recurrence_cluster.cuh `at_product`); zx, h0, the exchanged h and dz,
// and the hs and dzx stacks stay f32.  The pre-pass reads the bf16 weight
// and rounds hprev the same way.  dwht is the f32 product of the f32 h
// stack and dzx (the JAX kernel's f32 dwh scratch); the wrapper casts it
// to wht's dtype, as the JAX VJP does (:1024).
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
// prefetches its own zx (gout and h_t or pre_t) values several steps
// ahead into a cp.async ring, so no step waits on device memory.  The
// activation is a launch argument, switched on in each update (the same
// kind in every lane): one instantiation a plan for the nineteen kinds
// other than tanh, and tanh's own, whose switch cost 6-9% of the RNN's
// time at (500, 2, 128, 128) (recurrence_ab.py).
// The plan (C, R) is a function of (D, B, H) (ops/_recurrence.py mirrors
// it): C = 1 at SimpleRNN's width, where one block's barrier is cheaper
// than a cluster's.  The product sums runs of 32 terms from zero, then
// runs of those: at H = 14,528 one fp32 chain of H roundings leaves h
// about ten times further from the exact sum than the blocked plain
// version.

#include "rnn_cells.cuh"

extern "C" {

// Forward over zx (T, D, B, H) and wht (D, H, H) from h0 (D, B, H), or
// zeros when h0 is null, under activation `act` (a kind code) with
// parameters a, b, c: hs (T, D, B, H), under the plan of the shape (C = R
// = 0) or at (C, R).  One launch.  Returns the cudaError_t of the launch.
// The _bf16 form (rnn_bf16.cu) takes wht in bf16; zx, h0 and hs are f32
// in both.
int bigdl_rnn_fwd_f32(const float* zx, const float* wht, const float* h0,
                      float* hs, int T, int D, int B, int H, int C, int R,
                      int act, float a, float b, float c, int device,
                      void* stream) {
  return rnn_fwd<RnnFwd>(zx, wht, h0, hs, T, D, B, H, C, R, act, a, b, c,
                         device, stream);
}

// Backward: dzx (T, D, B, H) f32 from wht, the forward's hs and the
// cotangent gout (T, D, B, H) under activation `act`, under the plan as
// the forward's.  tanh: one launch, zx and h0 unread.  Any other kind: two
// launches on the stream, the pre-activations of every step from zx, the
// h stack and h0 (or zeros when null) into dzx, then the serial loop.  The
// forms as the forward's.
int bigdl_rnn_bwd_f32(const float* zx, const float* wht, const float* hs,
                      const float* h0, const float* gout, float* dzx, int T,
                      int D, int B, int H, int C, int R, int act, float a,
                      float b, float c, int device, void* stream) {
  return rnn_bwd<RnnBwd>(zx, wht, hs, h0, gout, dzx, T, D, B, H, C, R, act,
                         a, b, c, device, stream);
}

// The plan of the forward (bwd = 0) or backward (1) at (D, B, H) into
// out[8]: C, R, RT, KP, S, staged, depth, bytes (C = 0: none fits).
void bigdl_rnn_plan(int bwd, int D, int B, int H, int* out) {
  plan_out(bwd ? plan_of<RnnBwd<true>>(D, B, H)
               : plan_of<RnnFwd<true>>(D, B, H),
           out);
}

// The plan of the bf16-weight form.
void bigdl_rnn_plan_bf16(int bwd, int D, int B, int H, int* out) {
  plan_out(bwd ? plan_of<RnnBwdBf16<true>>(D, B, H)
               : plan_of<RnnFwdBf16<true>>(D, B, H),
           out);
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
