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
// What this design does about it: the forward block of
// recurrence_block.cuh, as bilstm.cu's forward has it, at D = 1 and
// without the c stack.  One block per tile of R batch rows walks all T
// steps, so no block waits for another and no step needs a grid-wide
// barrier; its rows' h and c stay in shared memory, set from h0 and c0
// once; each step it reads wht through L2, R rows at a time, while
// cp.async stages the step's zx rows into shared memory under the
// product.  The product sums runs of 32 terms from zero, then runs of
// those (matvec's CHUNK): at the largest H the block holds one fp32 chain
// of H roundings would leave h further from the exact value than the
// blocked plain version.  R is 8, 4, 2 or 1 by the row rule of
// recurrence_block.cuh over this block alone (there is no backward
// block), up to H = 5,811; the wrapper refuses a larger H.  The TPU
// kernel's grid of T sequential steps, with h and c carried in VMEM
// scratch, has no counterpart here.

#include "recurrence_block.cuh"

namespace {

// each run of kChunk products summed from zero, then added (matvec)
constexpr int kChunk = 32;

// Shared memory of the block at R rows, in floats.
__host__ __device__ inline int scan_smem_floats(int H, int R) {
  const int G = groups(H, 4 * H);
  return R * 10 * H + (G > 1 ? G * R * 4 * H : 0);
}

inline int scan_rows(int H) {
  return rows_for([H](int r) { return 4 * scan_smem_floats(H, r); });
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    lstm_scan_kernel(const float* __restrict__ zx,
                     const float* __restrict__ wht,
                     const float* __restrict__ h0,
                     const float* __restrict__ c0, float* __restrict__ hs,
                     Dims dm) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H = dm.H, H4 = 4 * H, tid = threadIdx.x;
  const int b0 = blockIdx.x * R;
  const int rows = min(R, dm.B - b0);
  float* h_s = smem;              // [H][R], rows past `rows` stay 0
  float* c_s = h_s + H * R;       // [rows][H]
  float* z_s = c_s + H * R;       // [R][4H]: h . wht
  float* x_s = z_s + H4 * R;      // [rows][4H]: this step's zx rows
  float* red = x_s + H4 * R;      // [G][R][4H]
  const int G = groups(H, H4);
  for (int e = tid; e < H * R; e += kThreads) {
    const int u = e / R, r = e - u * R;
    h_s[e] = r < rows ? h0[(size_t)(b0 + r) * H + u] : 0.0f;
    c_s[e] = e < rows * H ? c0[(size_t)b0 * H + e] : 0.0f;
  }
  __syncthreads();
  for (int t = 0; t < dm.T; ++t) {
    const size_t row0 = (size_t)t * dm.B + b0;
    const float* src = zx + row0 * H4;
    for (int e = tid; e < rows * H4; e += kThreads)
      cp_async4(x_s + e, src + e);
    matvec<R, false, kChunk>(wht, H, H4, h_s, z_s, red, G);
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
      hs[(row0 + r) * H + u] = h;
    }
    __syncthreads();
  }
}

template <int R>
cudaError_t launch(const float* zx, const float* wht, const float* h0,
                   const float* c0, float* hs, const Dims& dm,
                   cudaStream_t st) {
  const int bytes = scan_smem_floats(dm.H, R) * (int)sizeof(float);
  cudaError_t err = set_smem((const void*)lstm_scan_kernel<R>, bytes);
  if (err != cudaSuccess) return err;
  lstm_scan_kernel<R><<<(dm.B + R - 1) / R, kThreads, bytes, st>>>(
      zx, wht, h0, c0, hs, dm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// hs (T, B, H) over zx (T, B, 4H) and wht (H, 4H) from h0, c0 (B, H).
// One launch.  Returns the cudaError_t of the launch.
int bigdl_lstm_scan_f32(const float* zx, const float* wht, const float* h0,
                        const float* c0, float* hs, int T, int B, int H,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Dims dm{T, 1, B, H};
  if (empty(dm)) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (scan_rows(H)) {
    case 8: return (int)launch<8>(zx, wht, h0, c0, hs, dm, st);
    case 4: return (int)launch<4>(zx, wht, h0, c0, hs, dm, st);
    case 2: return (int)launch<2>(zx, wht, h0, c0, hs, dm, st);
    case 1: return (int)launch<1>(zx, wht, h0, c0, hs, dm, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
