// NCHW max pooling, forward and backward, fp32, for Hopper (sm_90a).
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_mosaic_mp_fwd_kernel`,
// `_mosaic_mp_fwd_kernel_primal` and `_mosaic_mp_bwd_kernel` (the Mosaic
// pair behind `mosaic_maxpool2d`).  Contract, as there:
//   forward  x (N, C, H, W) -> y (N, C, OH, OW) and, when a gradient is
//            needed, the int32 window argmax i * kw + j of each output;
//            any window, stride and explicit pads (lo_h, lo_w; the high
//            pads only set OH and OW); padded taps read as -inf; taps are
//            walked in row-major order with a strict >, so the FIRST max
//            wins a tie (XLA select_and_scatter's rule), a NaN at the
//            window's first tap is kept and a NaN at a later tap never
//            wins;
//   backward (argmax, g) -> dx (N, C, H, W): each input element sums
//            g[oh, ow] over the outputs whose window covers it and whose
//            stored argmax names it.  A gather: no atomics, no scatter.
//
// What bounds it on this card: bytes.  The forward reads x and writes y
// and the argmax, the backward reads g and the argmax and writes dx, with
// one compare (or one add) per tap: far below the fp32 ridge.
//
// What this design does about it: the forward takes one thread per
// output element, neighbouring threads on neighbouring W positions, so
// loads and stores of a warp are contiguous (strided by the pool stride
// on the forward's reads); overlapping windows re-read x from L1/L2, not
// from device memory.  The backward takes one block per tile of input
// rows of one (n, c) plane (the plane on blockIdx.x, the tile on
// blockIdx.y), or per run of whole planes where planes are small.  The
// block stages the g and argmax rows of the outputs that cover its rows
// in shared memory, each read once in coalesced 16-byte copies, beside a
// table of the covering output rows of each of its input rows and of the
// covering output columns of each input column, so no element divides.
// Each thread then forms runs of four consecutive dx from shared memory
// with 32-bit indices inside the block's run and writes each as one
// float4 (scalar stores before the first 16-byte boundary and after the
// last).  Where even one input row's covering
// outputs do not fit shared memory (a huge window), the same kernel
// reads g and argmax through L1 and computes the bounds per element.
// The TPU kernel's phase-folded NHWC frame and row blocking exist for
// its lanes and VMEM and are not carried over: NCHW stays as it is, with
// no transpose or padding pass.

#include <cuda_runtime.h>

#include <cstdint>

#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

template <bool WITH_ARGMAX>
__global__ void __launch_bounds__(kThreads)
    maxpool2d_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                         int* __restrict__ argmax, long long total, int H,
                         int W, int OH, int OW, int kh, int kw, int sh, int sw,
                         int plh, int plw) {
  const long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (o >= total) return;
  const int ow = (int)(o % OW);
  const long long t = o / OW;
  const int oh = (int)(t % OH);
  const long long nc = t / OH;
  const float* xp = x + nc * H * W;
  const int h0 = oh * sh - plh, w0 = ow * sw - plw;
  float best = -CUDART_INF_F;
  int arg = 0;
  for (int i = 0; i < kh; ++i) {
    const int ih = h0 + i;
    const bool row_in = ih >= 0 && ih < H;
    for (int j = 0; j < kw; ++j) {
      const int iw = w0 + j;
      const float v =
          (row_in && iw >= 0 && iw < W) ? xp[ih * W + iw] : -CUDART_INF_F;
      if ((i == 0 && j == 0) || v > best) {  // strict >: first max wins
        best = v;
        arg = i * kw + j;
      }
    }
  }
  y[o] = best;
  if (WITH_ARGMAX) argmax[o] = arg;
}

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// The outputs o whose window covers padded position p, o * s <= p <= o *
// s + k - 1, clipped to [0, O): (lo, hi), empty where lo > hi.
__host__ __device__ inline int2 cover(int p, int k, int s, int O) {
  return make_int2(p < k ? 0 : (p - k + s) / s, imin(p / s, O - 1));
}

struct Geom {
  int H, W, OH, OW, kh, kw, sh, sw, plh, plw;
};

// input elements a backward block aims at (32 a thread: measured
// fastest on the H100 against 8 and 16 and against 128-thread blocks),
// and the shared memory it stages in at most
constexpr int kTileElems = 8192;
constexpr int kStageBytes = 48 * 1024;
constexpr int kMinBlocks = 264;   // two a streaming multiprocessor

// A (lo, hi) pair of bounds packed in one int, 16 bits each.
__host__ __device__ inline int pack(int2 c) {
  return (c.x & 0xffff) | (c.y << 16);
}
__device__ inline int2 unpack(int v) {
  return make_int2((short)(v & 0xffff), v >> 16);
}

// Output rows staged for a tile of TH input rows: at most (TH + kh - 2) /
// sh + 1.
__host__ __device__ inline int stage_rows(const Geom& gm, int TH) {
  return imin((TH + gm.kh - 2) / gm.sh + 1, gm.OH);
}

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

// Shared memory of a backward block of PB planes of TH input rows: the
// two bounds tables and the staged g and argmax rows.
inline long long bwd_smem_bytes(const Geom& gm, int TH, int PB) {
  return 4LL * round4(TH + gm.W) +
         8LL * round4(PB * stage_rows(gm, TH) * gm.OW);
}

// dx of the tiles of a block: PB planes from blockIdx.x * PB, rows [ih0,
// ih0 + TH) of each for the row tiles blockIdx.y, blockIdx.y + gridDim.y,
// ... (PB > 1 only with TH = H and every plane's outputs staged whole, so
// the block's dx, g and argmax are each one run).  With STAGED, the
// covering bounds come from tables and g, argmax from the staged rows,
// else from device memory.  MR, MC > 0: an element has at most MR x MC
// covering outputs (ceil(kh / sh), ceil(kw / sw)), tried in an unrolled
// loop; 0: any window.  Each element sums g over its covering outputs in
// (oh, ow) order, as the per-element gather always has.
template <bool STAGED, int MR, int MC>
__global__ void __launch_bounds__(kThreads)
    maxpool2d_bwd_kernel(const float* __restrict__ g,
                         const int* __restrict__ argmax, float* __restrict__ dx,
                         Geom gm, int NC, int PB, int TH, int tiles) {
  extern __shared__ float4 smem4[];
  const int W = gm.W, OH = gm.OH, OW = gm.OW, nt = blockDim.x;
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PB, np = imin(PB, NC - p0);
  const float* gp = g + (size_t)p0 * OH * OW;
  const int* ap = argmax + (size_t)p0 * OH * OW;
  const int nr = stage_rows(gm, TH);
  int* cols = reinterpret_cast<int*>(smem4);   // [W]: covering ow
  int* rows = cols + W;                        // [TH]: covering oh
  float* g_s = reinterpret_cast<float*>(smem4 + round4(W + TH) / 4);
  int* a_s = reinterpret_cast<int*>(g_s + round4(PB * nr * OW));
  // g_s, a_s: [np][nr][OW], 16-byte aligned
  if (STAGED) {
    for (int iw = tid; iw < W; iw += nt)
      cols[iw] = pack(cover(iw + gm.plw, gm.kw, gm.sw, OW));
  }
  for (int tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const int ih0 = tile * TH, th = imin(TH, gm.H - ih0);
    // the outputs covering the tile's rows: [oa, ob] of each plane
    const int oa = cover(ih0 + gm.plh, gm.kh, gm.sh, OH).x;
    const int ob = cover(ih0 + th - 1 + gm.plh, gm.kh, gm.sh, OH).y;
    // a plane's outputs: staged, nr rows from oa, or in device memory
    const int base = STAGED ? oa : 0, pstride = (STAGED ? nr : OH) * OW;
    const float* G = STAGED ? g_s : gp;
    const int* A = STAGED ? a_s : ap;
    if (STAGED) {
      __syncthreads();   // the previous tile's reads are done
      for (int r = tid; r < th; r += nt)
        rows[r] = pack(cover(ih0 + r + gm.plh, gm.kh, gm.sh, OH));
      // one run each, in 16-byte copies where both start aligned
      const float* gr = gp + oa * OW;
      const int* ar = ap + oa * OW;
      const int ns = np * (ob - oa + 1) * OW;
      const int ns4 = ((reinterpret_cast<uintptr_t>(gr) |
                        reinterpret_cast<uintptr_t>(ar)) & 15) == 0 ? ns / 4
                                                                   : 0;
      for (int e = tid; e < ns4; e += nt) {
        reinterpret_cast<float4*>(g_s)[e] =
            reinterpret_cast<const float4*>(gr)[e];
        reinterpret_cast<int4*>(a_s)[e] = reinterpret_cast<const int4*>(ar)[e];
      }
      for (int e = 4 * ns4 + tid; e < ns; e += nt) {
        g_s[e] = gr[e];
        a_s[e] = ar[e];
      }
      __syncthreads();
    }
    const auto row_bounds = [&](int r) {
      if (STAGED) return unpack(rows[r]);
      return cover(ih0 + r + gm.plh, gm.kh, gm.sh, OH);
    };
    const auto col_bounds = [&](int iw) {
      if (STAGED) return unpack(cols[iw]);
      return cover(iw + gm.plw, gm.kw, gm.sw, OW);
    };
    // dx at (ih0 + r, iw) of the block's plane pl, its row's and
    // column's covering outputs rb and cb
    const auto value = [&](int pl, int r, int iw, int2 rb, int2 cb) {
      const int ph = ih0 + r + gm.plh, pw = iw + gm.plw;
      const int o0 = pl * pstride - base * OW;
      float acc = 0.0f;
      if constexpr (MR > 0) {
#pragma unroll
        for (int u = 0; u < MR; ++u) {
          const int oh = rb.x + u;
          if (oh > rb.y) break;
          const int i = ph - oh * gm.sh, o = o0 + oh * OW;
#pragma unroll
          for (int v = 0; v < MC; ++v) {
            const int ow = cb.x + v;
            if (ow > cb.y) break;
            if (A[o + ow] == i * gm.kw + (pw - ow * gm.sw)) acc += G[o + ow];
          }
        }
      } else {
        for (int oh = rb.x; oh <= rb.y; ++oh) {
          const int i = ph - oh * gm.sh, o = o0 + oh * OW;
          for (int ow = cb.x; ow <= cb.y; ++ow)
            if (A[o + ow] == i * gm.kw + (pw - ow * gm.sw)) acc += G[o + ow];
        }
      }
      return acc;
    };
    // the block's dx is one run of np * th * W elements: scalars up to
    // its first 16-byte boundary, float4s, then scalars
    float* dt = dx + ((size_t)p0 * gm.H + ih0) * W;
    const int plane = th * W, n = np * plane;
    const int head = imin(
        (int)((16 - (reinterpret_cast<uintptr_t>(dt) & 15)) & 15) / 4, n);
    const int n4 = (n - head) / 4, scalars = n - 4 * n4;
    // every quad four of one row (the same path in every lane)
    const bool in_rows = STAGED && (W & 3) == 0 && head == 0;
    for (int k = tid; k < scalars; k += nt) {
      const int e = k < head ? k : k + 4 * n4;
      const int pl = e / plane, rest = e - pl * plane;
      const int r = rest / W, iw = rest - r * W;
      dt[e] = value(pl, r, iw, row_bounds(r), col_bounds(iw));
    }
    for (int q = tid; q < n4; q += nt) {
      const int e = head + 4 * q;
      int pl = e / plane, r = (e - pl * plane) / W;
      int iw = e - pl * plane - r * W;
      int2 rb = row_bounds(r);
      float v[4];
      if (in_rows) {
        const int4 c = *reinterpret_cast<const int4*>(cols + iw);
        const int cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = value(pl, r, iw + k, rb, unpack(cv[k]));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[k] = value(pl, r, iw, rb, col_bounds(iw));
          if (++iw == W && k < 3) {
            iw = 0;
            if (++r == th) {
              r = 0;
              ++pl;
            }
            rb = row_bounds(r);
          }
        }
      }
      *reinterpret_cast<float4*>(dt + e) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <bool STAGED, int MR, int MC>
void launch_bwd(const float* g, const int* argmax, float* dx, const Geom& gm,
                int NC, int PB, int TH, cudaStream_t st) {
  const int tiles = (gm.H + TH - 1) / TH;
  const long long quads = ((long long)PB * TH * gm.W + 3) / 4;
  const long long warps = (quads + 31) / 32 * 32;
  const int threads =
      warps > kThreads ? kThreads : (warps < 64 ? 64 : (int)warps);
  const dim3 grid((unsigned)((NC + PB - 1) / PB),
                  (unsigned)imin(tiles, 65535));
  const size_t smem = STAGED ? bwd_smem_bytes(gm, TH, PB) : 0;
  maxpool2d_bwd_kernel<STAGED, MR, MC><<<grid, threads, smem, st>>>(
      g, argmax, dx, gm, NC, PB, TH, tiles);
}

unsigned grid_for(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Forward over NC = N * C planes; `argmax` null takes the primal variant
// that writes no argmax.  Returns the cudaError_t of the launch.
int bigdl_maxpool2d_fwd_f32(const float* x, float* y, int* argmax, long long NC,
                            int H, int W, int OH, int OW, int kh, int kw, int sh,
                            int sw, int plh, int plw, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = NC * OH * OW;
  if (argmax != nullptr)
    maxpool2d_fwd_kernel<true><<<grid_for(total), kThreads, 0, st>>>(
        x, y, argmax, total, H, W, OH, OW, kh, kw, sh, sw, plh, plw);
  else
    maxpool2d_fwd_kernel<false><<<grid_for(total), kThreads, 0, st>>>(
        x, y, nullptr, total, H, W, OH, OW, kh, kw, sh, sw, plh, plw);
  return (int)cudaGetLastError();
}

// Backward: dx (NC, H, W) from the cotangent g and the argmax (NC, OH,
// OW).  A block takes about kTileElems input elements: whole rows of one
// plane, evenly split, or as many whole planes as fit where a plane is
// smaller and its outputs are staged whole; fewer rows where their
// staged outputs would pass kStageBytes, and no staging where one row's
// would; a quarter as many threads as elements, 64 to kThreads.  One
// launch.
int bigdl_maxpool2d_bwd_f32(const float* g, const int* argmax, float* dx,
                            long long NC, int H, int W, int OH, int OW, int kh,
                            int kw, int sh, int sw, int plh, int plw,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (NC == 0 || H == 0 || W == 0) return 0;
  if (NC > 0x7fffffff || (long long)H * W > 0x7fffffff ||
      (long long)OH * OW > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Geom gm{H, W, OH, OW, kh, kw, sh, sw, plh, plw};
  const long long per = ((long long)H * W + kTileElems - 1) / kTileElems;
  int TH = (int)((H + per - 1) / per), PB = 1;
  if (2LL * H * W <= kTileElems && cover(plh, kh, sh, OH).x == 0 &&
      cover(H - 1 + plh, kh, sh, OH).y == OH - 1 && stage_rows(gm, H) == OH) {
    // as many whole planes as fit, and at least kMinBlocks blocks
    const long long fit = kTileElems / ((long long)H * W);
    const long long spread = (NC + kMinBlocks - 1) / kMinBlocks;
    PB = (int)(fit < spread ? fit : spread);
    while (PB > 1 && bwd_smem_bytes(gm, H, PB) > kStageBytes) --PB;
  }
  while (TH > 1 && bwd_smem_bytes(gm, TH, PB) > kStageBytes) TH = (TH + 1) / 2;
  const bool staged = bwd_smem_bytes(gm, TH, PB) <= kStageBytes &&
                      OH < 32768 && OW < 32768;
  const int mr = (kh + sh - 1) / sh, mc = (kw + sw - 1) / sw;
  const int NCi = (int)NC;
  if (!staged) {
    launch_bwd<false, 0, 0>(g, argmax, dx, gm, NCi, 1, TH, st);
  } else if (mr == 1 && mc == 1) {
    launch_bwd<true, 1, 1>(g, argmax, dx, gm, NCi, PB, TH, st);
  } else if (mr == 2 && mc == 2) {
    launch_bwd<true, 2, 2>(g, argmax, dx, gm, NCi, PB, TH, st);
  } else {
    launch_bwd<true, 0, 0>(g, argmax, dx, gm, NCi, PB, TH, st);
  }
  return (int)cudaGetLastError();
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
