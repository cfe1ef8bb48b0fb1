// The bf16-weight form of the RNN recurrence (rnn.cu's header says what it
// computes, what bounds it and how), on the cells of rnn_cells.cuh: a
// library of its own, so that nvcc builds the two forms in parallel.

#include "rnn_cells.cuh"

extern "C" {

// Forward and backward, as rnn.cu's bigdl_rnn_fwd_f32 and
// bigdl_rnn_bwd_f32, on wht in bf16 (zx, h0, hs, gout and dzx f32).
int bigdl_rnn_fwd_bf16(const float* zx, const bf16* wht, const float* h0,
                       float* hs, int T, int D, int B, int H, int C, int R,
                       int act, float a, float b, float c, int device,
                       void* stream) {
  return rnn_fwd<RnnFwdBf16>(zx, wht, h0, hs, T, D, B, H, C, R, act, a, b,
                             c, device, stream);
}

int bigdl_rnn_bwd_bf16(const float* zx, const bf16* wht, const float* hs,
                       const float* h0, const float* gout, float* dzx, int T,
                       int D, int B, int H, int C, int R, int act, float a,
                       float b, float c, int device, void* stream) {
  return rnn_bwd<RnnBwdBf16>(zx, wht, hs, h0, gout, dzx, T, D, B, H, C, R,
                             act, a, b, c, device, stream);
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
