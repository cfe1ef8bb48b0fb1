// Stride-1 NCHW max pooling, forward and backward, fp32, for Hopper
// (sm_90a).
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_maxpool_fwd_kernel` and
// `_maxpool_bwd_kernel` (the pair behind `maxpool2d`).  Contract:
//   forward  x (N, C, H, W) -> y (N, C, OH, OW), OH = H + plh + phh - kh + 1
//            (the high pads only set OH and OW); any window and pads;
//            padded taps read as -inf; y only, no argmax;
//   backward (x, g) -> dx (N, C, H, W): each output's first maximum is
//            recomputed from x (taps in row-major order, strict >), and
//            each input element sums, over taps (i, j) in row-major order
//            (the JAX kernel's order), the cotangents of the outputs whose
//            first maximum it is.  A gather: no atomics, deterministic.
// NaN follows csrc/maxpool2d.cu (the Mosaic rule): a NaN at a window's
// first tap is the output and its first max, a NaN at a later tap never
// wins.  So SpatialMaxPooling gives one answer whatever its stride; the
// JAX stride-1 kernel (jnp.maximum) spreads a NaN from any tap instead.
//
// What bounds it on this card: bytes.  The forward reads x and writes y,
// the backward reads x and g and writes dx, with kh*kw compares (and
// adds) per element: far below the fp32 ridge.
//
// What this design does about it: a block stages one tile of x with its
// halo in shared memory (-inf where the window leaves the input), so each
// element is read from device memory about once however much the windows
// overlap.  Tiles cover up to 1024 outputs; a plane that small is one
// tile and a block takes several such planes (Inception's 28x28, 14x14
// and 7x7 planes: 1, 5 and 20 a block); a larger plane is cut into tiles
// whose halos overlap.  The backward's tile of dx needs the first max of
// every output whose window reaches it (the tile plus a (kh-1, kw-1) halo
// of outputs): it computes those once into shared memory (tap index and
// cotangent), then each dx element gathers from there.  A window too wide
// for any tile in 227 KB of shared memory takes the unstaged kernels, which
// read x from device memory tap by tap; nothing raises for a shape.
// Threads walk a block's elements flat, so a 7x7 plane keeps them as busy
// as a 28x28 one; the flat index is split into (plane, row, column) by
// multiply-and-shift divisions by launch constants (no integer divide in
// the loops), and the 3x3 window (Inception's) is unrolled at compile
// time.

#include <cuda_runtime.h>

#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileOutputs = 1024;
constexpr size_t kSmemDefault = 48 * 1024;
constexpr size_t kSmemMax = 232448;  // 227 KB, opted in per kernel

// n / d for 0 <= n < 2^31 as a multiply-high and a shift (the divisor
// fixed at launch; the magic number as in PyTorch's IntDivider).
struct FastDiv {
  unsigned d, m, s;
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while (s < 32 && (1ull << s) < d) ++s;
  const unsigned long long one = 1;
  return {d, (unsigned)(((one << 32) * ((one << s) - d)) / d + 1), s};
}

struct Geom {
  long long NC;
  int H, W, OH, OW, kh, kw, plh, plw;
  int TH, TW, P;  // tile rows and columns (forward: of y, backward: of dx)
  int tiles_h, tiles_w;
  long long blocks;
  // in-block index splits: forward stage (SH*SW, SW) and tile (TH*TW,
  // TW); backward stage, region (RH*RW, RW) and tile
  FastDiv stage_plane, stage_row, reg_plane, reg_row, tile_plane, tile_row;
};

// The first maximum of the window whose top-left tap `at(0, 0)` names:
// strict >, so the first max wins a tie and a NaN counts only at tap 0.
// KH, KW > 0 fix the window at compile time; 0 takes kh, kw.
template <int KH, int KW, class At>
__device__ __forceinline__ int first_max(At at, int kh, int kw,
                                         float* best_out) {
  if (KH > 0) kh = KH;
  if (KW > 0) kw = KW;
  float best = at(0, 0);
  int arg = 0;
#pragma unroll
  for (int i = 0; i < (KH > 0 ? KH : kh); ++i)
#pragma unroll
    for (int j = 0; j < (KW > 0 ? KW : kw); ++j) {
      const float v = at(i, j);
      if (v > best) {
        best = v;
        arg = i * kw + j;
      }
    }
  *best_out = best;
  return arg;
}

// (plane, row, column) of flat index e of planes of `plane` elements,
// rows of `row` elements
__device__ __forceinline__ void split(unsigned e, const FastDiv& plane,
                                      const FastDiv& row, int* q, int* r,
                                      int* c) {
  const unsigned qq = plane.div(e), rem = e - qq * plane.d;
  const unsigned rr = row.div(rem);
  *q = (int)qq;
  *r = (int)rr;
  *c = (int)(rem - rr * row.d);
}

__device__ __forceinline__ float x_at(const float* __restrict__ xp, int H,
                                      int W, int ih, int iw) {
  return (ih >= 0 && ih < H && iw >= 0 && iw < W) ? xp[(long long)ih * W + iw]
                                                  : -CUDART_INF_F;
}

// Stage rows [r0, r0 + SH) x cols [c0, c0 + SW) of `np` planes of x
// (input coordinates) into xs, -inf outside the input.
__device__ __forceinline__ void stage_x(const float* __restrict__ x,
                                        float* xs, const Geom& g,
                                        long long nc0, int np, int r0,
                                        int c0) {
  const int n = np * (int)g.stage_plane.d;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int q, r, c;
    split(e, g.stage_plane, g.stage_row, &q, &r, &c);
    xs[e] = x_at(x + (nc0 + q) * g.H * g.W, g.H, g.W, r0 + r, c0 + c);
  }
}

template <int KH, int KW>
__global__ void __launch_bounds__(kThreads)
    s1_fwd_staged(const float* __restrict__ x, float* __restrict__ y, Geom g) {
  extern __shared__ float xs[];
  const int SW = (int)g.stage_row.d, per_stage = (int)g.stage_plane.d;
  const long long tiles = (long long)g.tiles_h * g.tiles_w;
  for (long long blk = blockIdx.x; blk < g.blocks; blk += gridDim.x) {
    const long long nc0 = (blk / tiles) * g.P;
    const int tile = (int)(blk % tiles);
    const int oh0 = (tile / g.tiles_w) * g.TH, ow0 = (tile % g.tiles_w) * g.TW;
    const int np = (int)min((long long)g.P, g.NC - nc0);
    // output (oh, ow)'s window starts at input (oh - plh, ow - plw)
    stage_x(x, xs, g, nc0, np, oh0 - g.plh, ow0 - g.plw);
    __syncthreads();
    const int n = np * (int)g.tile_plane.d;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      int q, r, c;
      split(e, g.tile_plane, g.tile_row, &q, &r, &c);
      const int oh = oh0 + r, ow = ow0 + c;
      if (oh >= g.OH || ow >= g.OW) continue;
      const float* w = xs + q * per_stage + r * SW + c;
      float best;
      first_max<KH, KW>([&](int i, int j) { return w[i * SW + j]; }, g.kh,
                        g.kw, &best);
      y[((nc0 + q) * g.OH + oh) * g.OW + ow] = best;
    }
    __syncthreads();  // xs is restaged by the next tile
  }
}

template <int KH, int KW>
__global__ void __launch_bounds__(kThreads)
    s1_bwd_staged(const float* __restrict__ x, const float* __restrict__ gy,
                  float* __restrict__ dx, Geom g) {
  extern __shared__ float smem[];
  const int kh = KH > 0 ? KH : g.kh, kw = KW > 0 ? KW : g.kw;
  // dx tile rows [ih0, ih0 + TH); the outputs whose windows reach it:
  // rows [ih0 + plh - (kh-1), ih0 + plh + TH), RH of them; their windows'
  // x: rows [ih0 - (kh-1), ih0 + TH + kh - 1), SH of them (columns alike)
  const int RW = (int)g.reg_row.d, rper = (int)g.reg_plane.d;
  const int SW = (int)g.stage_row.d, per_stage = (int)g.stage_plane.d;
  float* xs = smem;
  float* gs = xs + g.P * per_stage;
  int* ts = reinterpret_cast<int*>(gs + g.P * rper);
  const long long tiles = (long long)g.tiles_h * g.tiles_w;
  for (long long blk = blockIdx.x; blk < g.blocks; blk += gridDim.x) {
    const long long nc0 = (blk / tiles) * g.P;
    const int tile = (int)(blk % tiles);
    const int ih0 = (tile / g.tiles_w) * g.TH, iw0 = (tile % g.tiles_w) * g.TW;
    const int np = (int)min((long long)g.P, g.NC - nc0);
    const int oh_b = ih0 + g.plh - (kh - 1), ow_b = iw0 + g.plw - (kw - 1);
    stage_x(x, xs, g, nc0, np, ih0 - (kh - 1), iw0 - (kw - 1));
    __syncthreads();
    // first max (tap index) and cotangent of every output of the region;
    // an output outside the pool's (OH, OW) gets tap -1, never matched
    const int nr = np * rper;
    for (int e = threadIdx.x; e < nr; e += blockDim.x) {
      int q, r, c;
      split(e, g.reg_plane, g.reg_row, &q, &r, &c);
      const int oh = oh_b + r, ow = ow_b + c;
      int tap = -1;
      float gv = 0.0f;
      if (oh >= 0 && oh < g.OH && ow >= 0 && ow < g.OW) {
        const float* w = xs + q * per_stage + r * SW + c;
        float best;
        tap = first_max<KH, KW>([&](int i, int j) { return w[i * SW + j]; },
                                kh, kw, &best);
        gv = gy[((nc0 + q) * g.OH + oh) * g.OW + ow];
      }
      ts[e] = tap;
      gs[e] = gv;
    }
    __syncthreads();
    // dx (ih, iw) takes tap (i, j) of output (ih + plh - i, iw + plw - j),
    // region cell (a + kh-1 - i, b + kw-1 - j): always inside the region
    const int n = np * (int)g.tile_plane.d;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      int q, a, b;
      split(e, g.tile_plane, g.tile_row, &q, &a, &b);
      const int ih = ih0 + a, iw = iw0 + b;
      if (ih >= g.H || iw >= g.W) continue;
      const int* tq = ts + q * rper + (a + kh - 1) * RW + (b + kw - 1);
      const float* gq = gs + q * rper + (a + kh - 1) * RW + (b + kw - 1);
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < (KH > 0 ? KH : kh); ++i)
#pragma unroll
        for (int j = 0; j < (KW > 0 ? KW : kw); ++j) {
          const int cell = -i * RW - j;
          if (tq[cell] == i * kw + j) acc += gq[cell];
        }
      dx[((nc0 + q) * g.H + ih) * g.W + iw] = acc;
    }
    __syncthreads();  // the shared arrays are refilled by the next tile
  }
}

// Unstaged forms, for windows no shared-memory tile can hold.
__global__ void __launch_bounds__(kThreads)
    s1_fwd_direct(const float* __restrict__ x, float* __restrict__ y, Geom g) {
  const long long total = g.NC * g.OH * g.OW;
  for (long long o = (long long)blockIdx.x * kThreads + threadIdx.x;
       o < total; o += (long long)gridDim.x * kThreads) {
    const int ow = (int)(o % g.OW), oh = (int)(o / g.OW % g.OH);
    const float* xp = x + o / ((long long)g.OH * g.OW) * g.H * g.W;
    float best;
    first_max<0, 0>(
        [&](int i, int j) {
          return x_at(xp, g.H, g.W, oh - g.plh + i, ow - g.plw + j);
        },
        g.kh, g.kw, &best);
    y[o] = best;
  }
}

__global__ void __launch_bounds__(kThreads)
    s1_bwd_direct(const float* __restrict__ x, const float* __restrict__ gy,
                  float* __restrict__ dx, Geom g) {
  const long long total = g.NC * g.H * g.W;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const int iw = (int)(e % g.W), ih = (int)(e / g.W % g.H);
    const long long nc = e / ((long long)g.H * g.W);
    const float* xp = x + nc * g.H * g.W;
    float acc = 0.0f;
    for (int i = 0; i < g.kh; ++i)
      for (int j = 0; j < g.kw; ++j) {
        const int oh = ih + g.plh - i, ow = iw + g.plw - j;
        if (oh < 0 || oh >= g.OH || ow < 0 || ow >= g.OW) continue;
        float best;
        const int tap = first_max<0, 0>(
            [&](int ti, int tj) {
              return x_at(xp, g.H, g.W, oh - g.plh + ti, ow - g.plw + tj);
            },
            g.kh, g.kw, &best);
        if (tap == i * g.kw + j) acc += gy[(nc * g.OH + oh) * g.OW + ow];
      }
    dx[e] = acc;
  }
}

// Shared bytes of a tile: the forward stages (TH+kh-1)(TW+kw-1) floats a
// plane; the backward (TH+2(kh-1))(TW+2(kw-1)) floats plus a float and an
// int for each of (TH+kh-1)(TW+kw-1) outputs.
size_t smem_bytes(const Geom& g, bool bwd) {
  const size_t rh = g.TH + g.kh - 1, rw = g.TW + g.kw - 1;
  if (!bwd) return (size_t)g.P * rh * rw * sizeof(float);
  const size_t sh = rh + g.kh - 1, sw = rw + g.kw - 1;
  return (size_t)g.P * (sh * sw * sizeof(float) + rh * rw * 8);
}

// Tile the (rows, cols) plane of the tile's own elements (y forward, dx
// backward): up to kTileOutputs a tile, several whole planes a block when
// a plane fits, halved until the shared arrays fit.  Returns the bytes,
// or 0 when no tile fits (the unstaged kernels run).
size_t pick_tiles(Geom* g, int rows, int cols, bool bwd) {
  g->TW = cols < 64 ? cols : 64;
  g->TH = rows < kTileOutputs / g->TW ? rows : kTileOutputs / g->TW;
  if (g->TH < 1) g->TH = 1;
  long long P = 1;
  if (g->TH == rows && g->TW == cols)
    P = kTileOutputs / ((long long)rows * cols);
  if (P < 1) P = 1;
  if (P > g->NC) P = g->NC;
  g->P = (int)P;
  size_t bytes = smem_bytes(*g, bwd);
  while (bytes > kSmemMax) {
    if (g->P > 1)
      g->P = (g->P + 1) / 2;
    else if (g->TH > 1 && g->TH >= g->TW)
      g->TH = (g->TH + 1) / 2;
    else if (g->TW > 1)
      g->TW = (g->TW + 1) / 2;
    else
      return 0;
    bytes = smem_bytes(*g, bwd);
  }
  g->tiles_h = (rows + g->TH - 1) / g->TH;
  g->tiles_w = (cols + g->TW - 1) / g->TW;
  g->blocks = (g->NC + g->P - 1) / g->P * g->tiles_h * g->tiles_w;
  const unsigned rh = g->TH + g->kh - 1, rw = g->TW + g->kw - 1;
  const unsigned sh = bwd ? rh + g->kh - 1 : rh, sw = bwd ? rw + g->kw - 1
                                                          : rw;
  g->stage_plane = fast_div(sh * sw);
  g->stage_row = fast_div(sw);
  g->reg_plane = fast_div(rh * rw);
  g->reg_row = fast_div(rw);
  g->tile_plane = fast_div(g->TH * g->TW);
  g->tile_row = fast_div(g->TW);
  return bytes;
}

Geom make_geom(long long NC, int H, int W, int OH, int OW, int kh, int kw,
               int plh, int plw) {
  Geom g = {};
  g.NC = NC;
  g.H = H;
  g.W = W;
  g.OH = OH;
  g.OW = OW;
  g.kh = kh;
  g.kw = kw;
  g.plh = plh;
  g.plw = plw;
  return g;
}

unsigned grid_cap(long long blocks) {
  const long long cap = 1LL << 30;  // blocks loop over the rest
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

template <class K>
cudaError_t opt_in(K kernel, size_t bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

// Forward over NC = N * C planes.  Returns the cudaError_t of the launch.
int bigdl_maxpool2d_s1_fwd_f32(const float* x, float* y, long long NC, int H,
                               int W, int OH, int OW, int kh, int kw, int plh,
                               int plw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (NC == 0 || OH == 0 || OW == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Geom g = make_geom(NC, H, W, OH, OW, kh, kw, plh, plw);
  const size_t bytes = pick_tiles(&g, OH, OW, false);
  if (bytes == 0) {
    const long long total = NC * OH * OW;
    s1_fwd_direct<<<grid_cap((total + kThreads - 1) / kThreads), kThreads, 0,
                    st>>>(x, y, g);
  } else {
    auto kernel = (kh == 3 && kw == 3) ? s1_fwd_staged<3, 3>
                                       : s1_fwd_staged<0, 0>;
    err = opt_in(kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid_cap(g.blocks), kThreads, bytes, st>>>(x, y, g);
  }
  return (int)cudaGetLastError();
}

// Backward: dx (NC, H, W) from x and the cotangent g (NC, OH, OW).
int bigdl_maxpool2d_s1_bwd_f32(const float* x, const float* gy, float* dx,
                               long long NC, int H, int W, int OH, int OW,
                               int kh, int kw, int plh, int plw, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (NC == 0 || H == 0 || W == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Geom g = make_geom(NC, H, W, OH, OW, kh, kw, plh, plw);
  const size_t bytes = pick_tiles(&g, H, W, true);
  if (bytes == 0) {
    const long long total = NC * H * W;
    s1_bwd_direct<<<grid_cap((total + kThreads - 1) / kThreads), kThreads, 0,
                    st>>>(x, gy, dx, g);
  } else {
    auto kernel = (kh == 3 && kw == 3) ? s1_bwd_staged<3, 3>
                                       : s1_bwd_staged<0, 0>;
    err = opt_in(kernel, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid_cap(g.blocks), kThreads, bytes, st>>>(x, gy, dx, g);
  }
  return (int)cudaGetLastError();
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
