// Stride-1 NCHW max pooling, forward and backward, fp32, for Hopper
// (sm_90a).
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_maxpool_fwd_kernel` (:197)
// and `_maxpool_bwd_kernel` (:214), the pair behind `maxpool2d` (:311).
// Contract:
//   forward  x (N, C, H, W) -> y (N, C, OH, OW), OH = H + plh + phh - kh + 1
//            (the high pads only set OH and OW); any window and pads;
//            padded taps read as -inf; y only, no argmax;
//   backward (x, g) -> dx (N, C, H, W): each output's first maximum is
//            recomputed from x (taps in row-major order, strict >), and
//            each input element sums, over taps (i, j) in row-major order
//            (the JAX kernel's order) and from 0.0f, the cotangents of the
//            outputs whose first maximum it is.  A gather: no atomics,
//            deterministic.
// NaN follows csrc/maxpool2d.cu (the Mosaic rule): a NaN at a window's
// first tap is the output and its first max, a NaN at a later tap never
// wins.  So SpatialMaxPooling gives one answer whatever its stride; the
// JAX stride-1 kernel (jnp.maximum) spreads a NaN from any tap instead.
//
// What bounds it on this card: bytes.  The forward reads x and writes y
// (8 bytes an element at Inception's 3x3 p1), the backward reads x and g
// and writes dx (12), with kh*kw compares (and adds) an element: far
// below the fp32 ridge.  At 8 to 12 bytes an element the card moves an
// element in about half an SM cycle, so the goal is enough bytes in
// flight and an instruction budget of a few dozen an element: the
// compute, not the copies, is what held the former tile kernel and the
// first form of this one back.
//
// What this design does about it:
// - A group is P whole planes, or one band of rows of one plane (with the
//   window's halo rows).  Either is one contiguous run of x, g, y and dx
//   alike, so a group is staged by one bulk copy per tensor
//   (`cp.async.bulk`, the TMA's one-dimensional form), completing on an
//   mbarrier: no per-element address arithmetic, no halo columns (a tap
//   outside the plane is an index test in registers and reads -inf).  The
//   copy takes the run's 16-byte-aligned cover: a bulk copy needs 16-byte
//   addresses and sizes, and a 7x7 plane is 196 bytes.  The cover lies in
//   the 16-byte granules the run touches, so it cannot fault; the run
//   starts `lead` floats into the staged buffer.  One path fits every
//   alignment, so the plan never picks a copy path.
// - Blocks are persistent (grid = resident blocks, each walks groups
//   blockIdx.x + k * gridDim.x) with a ring of kStages staged groups: group
//   k + kStages is in flight while group k computes.  The backward stages
//   x and g of a group on one mbarrier: one round trip, not two.
// - A group is at most kMaxThreads tasks, one a thread where it fits: a
//   task is one output column of one plane over a strip of up to
//   kStripRows rows (Inception's 28x28, 14x14 and 7x7 planes: 4, 18 and 73
//   planes a group, 448, 504 and 511 tasks, every strip 7 rows).  A
//   thread decodes its task once for a group shape and keeps it while the
//   groups keep it (all but a tail group or an edge band), so the loop
//   does no integer division, and whole planes take no 64-bit one.
// - Outputs go to a shared buffer, then to device memory in float4 stores
//   from consecutive threads (the run's unaligned ends in floats).  The
//   forward's y buffer is doubled, so a group takes one block barrier; the
//   backward takes two (its taps are read by other threads' gathers).
// - The 3x3 window (Inception's) is compiled unrolled, with the window's
//   row maxima in registers: a task slides down its column, one new row
//   of kw taps an output.  The window's first max is the first row, in
//   row order, whose row maximum is strictly greater than the best so
//   far, with that row's first maximum: the row-major scan's first max,
//   tie for tie.  Rows after the first start from -inf, so a NaN there
//   never counts; the first row starts from its first tap, so a NaN at
//   tap (0, 0) is the output and is never beaten.  That is the row-major
//   scan's NaN rule too (a later row that started from its own NaN first
//   tap would hide its other taps: hence the -inf).  Other windows scan
//   row-major from shared memory.
// - The backward keeps each output's first-max tap in one byte where
//   kh*kw <= 256 (two bytes up to 65,536).  Its 3x3 gather slides a ring
//   of kh output rows' taps and cotangents down the dx column and adds,
//   without a branch, g where the tap matches and +0.0f where not, over
//   taps (i, j) in row-major order from 0.0f: the former tile kernel's
//   conditional sum, so dx is bit for bit its.
// - A plane whose tasks or bytes exceed a group is cut into row bands; a
//   window so tall that no band of one row fits takes the unstaged
//   kernels, which read x from device memory tap by tap.  Nothing raises
//   for a shape.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;   // a block's threads: a group's tasks
constexpr int kStripRows = 8;      // rows a task slides down, at most
constexpr int kStages = 3;         // staged groups in a block's ring
// blocks an SM the registers leave room for (64 registers a thread: a
// cap of 40 for three forward blocks cost more than the third block gave)
constexpr int kFwdBlocks = 2, kBwdBlocks = 2;
constexpr int kAlign = 16;         // bytes: a bulk copy's address and size
// two blocks an SM: 2 x (113 KB + the 1 KB the card reserves a block) is
// the SM's 228 KB; less the static mbarriers.  A band that needs more
// takes up to a block's 227 KB (one block an SM).
constexpr size_t kSmemCap = 113 * 1024 - 64;
constexpr size_t kSmemMax = 227 * 1024 - 64;
constexpr size_t kSmemDefault = 48 * 1024;

enum Path { kDirect = 0, kPlanes = 1, kBands = 2 };

// A launch's plan: which path, planes a group (1 in bands), the rows of
// the pass's own output a group (y forward, dx backward; all of them in
// planes), the staged rows a plane at most (x, and g backward), threads,
// groups and the dynamic shared bytes; bands a plane, and the floats of a
// stage's x and g and of the output buffer.
struct Plan {
  int path, planes, rows, xrows, grows, threads, bands;
  long long groups, smem, xbuf, gbuf, obuf;
};

struct Geom {
  long long NC;
  int H, W, OH, OW, kh, kw, plh, plw;
  int P, rows, bands;
  long long groups;
  int xbuf, gbuf, obuf;  // floats: a stage's x and g, the output buffer
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Floats from the 16-byte boundary below `p` to `p`.
__device__ __forceinline__ int lead_of(const float* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & (kAlign / 4 - 1));
}

// Bytes of the 16-byte-aligned cover of n floats from src, that is, the
// bytes a bulk copy of them moves.
__device__ __forceinline__ unsigned cover_bytes(const float* src,
                                                long long n) {
  return n > 0 ? (unsigned)((lead_of(src) + n + 3) / 4 * kAlign) : 0u;
}

// Starts the copy of n floats from src into buf (16-byte aligned), src[e]
// landing at buf[lead_of(src) + e].
__device__ __forceinline__ void stage_run(float* buf, const float* src,
                                          long long n, uint64_t* bar) {
  const unsigned bytes = cover_bytes(src, n);
  if (bytes) bulk_copy(buf, src - lead_of(src), bytes, bar);
}

// Writes n floats, src[lead_of(dst) + e] to dst[e]: float4 stores where a
// vector lies wholly in the run, floats at its two ends.
__device__ __forceinline__ void store_run(float* dst, const float* src,
                                          int n) {
  const int lead = lead_of(dst);
  float* base = dst - lead;
  const int nv = (lead + n + 3) / 4;
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const int e = 4 * v;
    if (e >= lead && e + 4 <= lead + n) {
      *reinterpret_cast<float4*>(base + e) =
          *reinterpret_cast<const float4*>(src + e);
    } else {
      for (int k = e; k < e + 4; ++k)
        if (k >= lead && k < lead + n) base[k] = src[k];
    }
  }
}

// A group: planes [p0, p0 + np) and rows [r0, r1) of the pass's own
// output; the staged rows of x [xr0, xr1) and of g [gr0, gr1) (whole
// planes when the plane is one band).
struct Group {
  long long p0;
  int np, r0, r1, xr0, xr1, gr0, gr1;
};

__device__ __forceinline__ Group group_at(const Geom& g, long long gi,
                                          bool bwd) {
  Group G;
  const long long pg = g.bands == 1 ? gi : gi / g.bands;
  const int b = (int)(gi - pg * g.bands);
  G.p0 = pg * g.P;
  G.np = (int)min((long long)g.P, g.NC - G.p0);
  const int total = bwd ? g.H : g.OH;
  G.r0 = b * g.rows;
  G.r1 = min(G.r0 + g.rows, total);
  if (g.bands == 1) {
    G.xr0 = 0, G.xr1 = g.H, G.gr0 = 0, G.gr1 = g.OH;
  } else if (!bwd) {
    // outputs [r0, r1) read x rows [r0 - plh, r1 - plh + kh - 1)
    G.xr0 = max(0, G.r0 - g.plh);
    G.xr1 = min(g.H, G.r1 - g.plh + g.kh - 1);
    G.gr0 = G.gr1 = 0;
  } else {
    // dx rows [r0, r1) take the outputs [r0 + plh - kh + 1, r1 + plh),
    // whose windows read x rows from plh above them, kh deep
    G.gr0 = max(0, G.r0 + g.plh - g.kh + 1);
    G.gr1 = min(g.OH, G.r1 + g.plh);
    G.xr0 = max(0, G.gr0 - g.plh);
    G.xr1 = min(g.H, G.gr1 - g.plh + g.kh - 1);
  }
  return G;
}

// A thread's first task of a group shape (np planes, n rows): decoded
// once and kept while the groups keep that shape, as all but a tail
// group or an edge band do, so the loop divides only when it changes.
struct Tasks {
  int np = -1, n = -1, total, width, len, q, col, off;
};

__device__ __forceinline__ void decode(Tasks& m, int t, int cols, int* q,
                                      int* col, int* off) {
  const int s = t / m.width, c = t - s * m.width;
  *q = c / cols;
  *col = c - *q * cols;
  *off = s * m.len;
}

// Threads fill a group's tasks: one output column of one plane over a
// strip of rows [a, b) cut into strips of at most kStripRows rows.
// fn(plane, column, first row, end row).
template <class Fn>
__device__ __forceinline__ void for_tasks(Tasks& m, int np, int cols, int a,
                                          int b, Fn fn) {
  const int n = b - a;
  if (n <= 0) return;
  if (m.np != np || m.n != n) {
    const int ns = (n + kStripRows - 1) / kStripRows;
    m.np = np;
    m.n = n;
    m.len = (n + ns - 1) / ns;
    m.width = np * cols;
    m.total = m.width * ns;
    if (threadIdx.x < m.total) decode(m, threadIdx.x, cols, &m.q, &m.col,
                                      &m.off);
  }
  if (threadIdx.x >= m.total) return;
  fn(m.q, m.col, a + m.off, min(b, a + m.off + m.len));
  for (int t = threadIdx.x + blockDim.x; t < m.total; t += blockDim.x) {
    int q, col, off;
    decode(m, t, cols, &q, &col, &off);
    fn(q, col, a + off, min(b, a + off + m.len));
  }
}

// The row scan of one window row: its maximum over taps that are not NaN
// (strict >, from -inf: the first maximum), that tap's column, and the
// row's first tap as read.
struct RowMax {
  float m, v0;
  int a;
};

template <int KW>
__device__ __forceinline__ RowMax row_max(const float* xq, int xr0, int H,
                                          int W, int ih, int iw0,
                                          const bool (&col)[KW]) {
  RowMax r{-CUDART_INF_F, -CUDART_INF_F, 0};
  const bool in = ih >= 0 && ih < H;
  const float* row = xq + (ih - xr0) * W + iw0;
#pragma unroll
  for (int j = 0; j < KW; ++j) {
    const float v = (in && col[j]) ? row[j] : -CUDART_INF_F;
    if (j == 0) r.v0 = v;
    if (v > r.m) {
      r.m = v;
      r.a = j;
    }
  }
  return r;
}

// Outputs (oh, ow) for oh in [oh0, oh1) (at most kStripRows) of one
// staged plane `xq` (its row xr0 first): sink(oh, max, first-max tap).
// KH, KW > 0: unrolled; the strip's kStripRows + KH - 1 row maxima are
// read first, into registers, then each output combines KH of them (see
// the header for why this is the row-major first max).  0: each window is
// scanned row-major from shared memory.
template <int KH, int KW, class Sink>
__device__ __forceinline__ void strip(const float* xq, int xr0, const Geom& g,
                                      int ow, int oh0, int oh1, Sink sink) {
  const int iw0 = ow - g.plw;
  if constexpr (KH > 0) {
    const int n = oh1 - oh0;
    bool col[KW];
#pragma unroll
    for (int j = 0; j < KW; ++j) col[j] = iw0 + j >= 0 && iw0 + j < g.W;
    RowMax r[KH];  // r[i]: window row i of output oh0 + e
#pragma unroll
    for (int i = 1; i < KH; ++i)
      r[i] = row_max<KW>(xq, xr0, g.H, g.W, oh0 - g.plh + i - 1, iw0, col);
#pragma unroll
    for (int e = 0; e < kStripRows; ++e) {
      if (e >= n) break;
#pragma unroll
      for (int i = 0; i + 1 < KH; ++i) r[i] = r[i + 1];
      r[KH - 1] =
          row_max<KW>(xq, xr0, g.H, g.W, oh0 + e - g.plh + KH - 1, iw0, col);
      float best = r[0].m;
      int tap = r[0].a;
      if (r[0].v0 != r[0].v0) {  // NaN at tap (0, 0)
        best = r[0].v0;
        tap = 0;
      }
#pragma unroll
      for (int i = 1; i < KH; ++i)
        if (r[i].m > best) {
          best = r[i].m;
          tap = i * KW + r[i].a;
        }
      sink(oh0 + e, best, tap);
    }
  } else {
    for (int oh = oh0; oh < oh1; ++oh) {
      const int ih0 = oh - g.plh;
      auto at = [&](int i, int j) {
        const int ih = ih0 + i, iw = iw0 + j;
        return (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
                   ? xq[(ih - xr0) * g.W + iw]
                   : -CUDART_INF_F;
      };
      float best = at(0, 0);
      int tap = 0;
      for (int i = 0; i < g.kh; ++i)
        for (int j = 0; j < g.kw; ++j) {
          const float v = at(i, j);
          if (v > best) {
            best = v;
            tap = i * g.kw + j;
          }
        }
      sink(oh, best, tap);
    }
  }
}

// dx (ih, iw) for ih in [ih0, ih1) (at most kStripRows) of one plane,
// unrolled, with the taps and cotangents of KH output rows in registers
// (kw of each; outside the staged outputs a tap that matches nothing),
// one new row a dx: each dx sums over taps (i, j) in row-major order,
// from 0.0f, g where the tap matches and +0.0f where not.  That is the conditional sum bit for bit:
// a sum from +0.0f is never -0.0f (only -0 + -0 is), and x + 0.0f == x
// for every other x, NaN and infinities included.
template <int KH, int KW, class Tap>
__device__ __forceinline__ void gather(const Tap* tq, const float* gq,
                                       float* dq, const Geom& g,
                                       const Group& G, int iw, int ih0,
                                       int ih1) {
  const int n = ih1 - ih0;
  bool col[KW];
#pragma unroll
  for (int j = 0; j < KW; ++j) {
    const int ow = iw + g.plw - j;
    col[j] = ow >= 0 && ow < g.OW;
  }
  // row k of the ring: output row ih + plh - (KH - 1) + k of dx row ih;
  // its tap i is row KH - 1 - i
  Tap t[KH][KW];
  float v[KH][KW];
  const int oh_first = ih0 + g.plh - (KH - 1);
  const Tap* trow = tq + (oh_first - G.gr0) * g.OW + iw + g.plw;
  const float* grow = gq + (oh_first - G.gr0) * g.OW + iw + g.plw;
  auto load = [&](int k, Tap* tk, float* vk) {
    const int oh = oh_first + k;
    const bool in = oh >= G.gr0 && oh < G.gr1;
#pragma unroll
    for (int j = 0; j < KW; ++j) {
      const bool ok = in && col[j];
      tk[j] = ok ? trow[k * g.OW - j] : (Tap)~(Tap)0;
      vk[j] = ok ? grow[k * g.OW - j] : 0.0f;
    }
  };
#pragma unroll
  for (int k = 1; k < KH; ++k) load(k - 1, t[k], v[k]);
#pragma unroll
  for (int e = 0; e < kStripRows; ++e) {
    if (e >= n) break;
#pragma unroll
    for (int k = 0; k + 1 < KH; ++k)
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        t[k][j] = t[k + 1][j];
        v[k][j] = v[k + 1][j];
      }
    load(e + KH - 1, t[KH - 1], v[KH - 1]);
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < KH; ++i)
#pragma unroll
      for (int j = 0; j < KW; ++j)
        acc += t[KH - 1 - i][j] == i * KW + j ? v[KH - 1 - i][j] : 0.0f;
    dq[e * g.W] = acc;
  }
}

// Starts group gi's copies into stage buffers xb (and gb) on `bar`.
__device__ __forceinline__ void stage_group(const float* x, const float* gy,
                                            float* xb, float* gb,
                                            uint64_t* bar, const Geom& g,
                                            long long gi, bool bwd) {
  const Group G = group_at(g, gi, bwd);
  const float* xs = x + G.p0 * g.H * g.W + (long long)G.xr0 * g.W;
  const long long nx = (long long)G.np * (G.xr1 - G.xr0) * g.W;
  const float* gs = bwd ? gy + G.p0 * g.OH * g.OW + (long long)G.gr0 * g.OW
                        : nullptr;
  const long long ng = bwd ? (long long)G.np * (G.gr1 - G.gr0) * g.OW : 0;
  mbar_expect(bar, cover_bytes(xs, nx) + (bwd ? cover_bytes(gs, ng) : 0u));
  stage_run(xb, xs, nx, bar);
  if (bwd) stage_run(gb, gs, ng, bar);
}

template <int KH, int KW>
__global__ void __launch_bounds__(kMaxThreads, kFwdBlocks)
    s1_fwd_staged(const float* __restrict__ x, float* __restrict__ y,
                  Geom g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  float* ybuf = smem + kStages * g.xbuf;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    mbar_fence_init();
    for (int s = 0; s < kStages; ++s) {
      const long long gi = blockIdx.x + (long long)s * gridDim.x;
      if (gi < g.groups)
        stage_group(x, nullptr, smem + s * g.xbuf, nullptr, &full[s], g, gi,
                    false);
    }
  }
  __syncthreads();
  Tasks tasks;
  int k = 0;
  for (long long gi = blockIdx.x; gi < g.groups; gi += gridDim.x, ++k) {
    const int s = k % kStages;
    const Group G = group_at(g, gi, false);
    const float* xsrc = x + G.p0 * g.H * g.W + (long long)G.xr0 * g.W;
    const float* xs = smem + s * g.xbuf + lead_of(xsrc);
    float* ydst = y + G.p0 * g.OH * g.OW + (long long)G.r0 * g.OW;
    float* ys = ybuf + (k & 1) * g.obuf;
    const int xplane = (G.xr1 - G.xr0) * g.W, yplane = (G.r1 - G.r0) * g.OW;
    mbar_wait(&full[s], (k / kStages) & 1);
    for_tasks(tasks, G.np, g.OW, G.r0, G.r1,
              [&](int q, int ow, int oh0, int oh1) {
      float* yq = ys + lead_of(ydst) + q * yplane + ow;
      strip<KH, KW>(xs + q * xplane, G.xr0, g, ow, oh0, oh1,
                    [&](int oh, float best, int) {
                      yq[(oh - G.r0) * g.OW] = best;
                    });
    });
    // y of this group is whole; stage s is read; the stores from the
    // other y buffer (group k - 1) are done
    __syncthreads();
    if (threadIdx.x == 0 && gi + (long long)kStages * gridDim.x < g.groups)
      stage_group(x, nullptr, smem + s * g.xbuf, nullptr, &full[s], g,
                  gi + (long long)kStages * gridDim.x, false);
    store_run(ydst, ys, G.np * yplane);
  }
}

template <int KH, int KW, class Tap>
__global__ void __launch_bounds__(kMaxThreads, kBwdBlocks)
    s1_bwd_staged(const float* __restrict__ x, const float* __restrict__ gy,
                  float* __restrict__ dx, Geom g) {
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  const int kh = KH > 0 ? KH : g.kh, kw = KW > 0 ? KW : g.kw;
  const int stage = g.xbuf + g.gbuf;
  float* dxbuf = smem + kStages * stage;
  Tap* taps = reinterpret_cast<Tap*>(dxbuf + g.obuf);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    mbar_fence_init();
    for (int s = 0; s < kStages; ++s) {
      const long long gi = blockIdx.x + (long long)s * gridDim.x;
      if (gi < g.groups)
        stage_group(x, gy, smem + s * stage, smem + s * stage + g.xbuf,
                    &full[s], g, gi, true);
    }
  }
  __syncthreads();
  Tasks outs, ins;  // the taps' tasks and dx's
  int k = 0;
  for (long long gi = blockIdx.x; gi < g.groups; gi += gridDim.x, ++k) {
    const int s = k % kStages;
    const Group G = group_at(g, gi, true);
    const float* xsrc = x + G.p0 * g.H * g.W + (long long)G.xr0 * g.W;
    const float* gsrc = gy + G.p0 * g.OH * g.OW + (long long)G.gr0 * g.OW;
    const float* xs = smem + s * stage + lead_of(xsrc);
    const float* gs = smem + s * stage + g.xbuf + lead_of(gsrc);
    float* dxdst = dx + G.p0 * g.H * g.W + (long long)G.r0 * g.W;
    float* dxs = dxbuf + lead_of(dxdst);
    const int xplane = (G.xr1 - G.xr0) * g.W;
    const int gplane = (G.gr1 - G.gr0) * g.OW;
    const int dplane = (G.r1 - G.r0) * g.W;
    mbar_wait(&full[s], (k / kStages) & 1);
    // the first-max tap of every staged output
    for_tasks(outs, G.np, g.OW, G.gr0, G.gr1,
              [&](int q, int ow, int oh0, int oh1) {
      Tap* tq = taps + q * gplane + ow;
      strip<KH, KW>(xs + q * xplane, G.xr0, g, ow, oh0, oh1,
                    [&](int oh, float, int tap) {
                      tq[(oh - G.gr0) * g.OW] = (Tap)tap;
                    });
    });
    __syncthreads();  // the taps are whole; stage s's x is read
    // dx (ih, iw) takes tap (i, j) of output (ih + plh - i, iw + plw - j)
    for_tasks(ins, G.np, g.W, G.r0, G.r1,
              [&](int q, int iw, int ih0, int ih1) {
      const Tap* tq = taps + q * gplane;
      const float* gq = gs + q * gplane;
      float* dq = dxs + q * dplane + iw;
      if constexpr (KH > 0) {
        gather<KH, KW>(tq, gq, dq + (ih0 - G.r0) * g.W, g, G, iw, ih0, ih1);
        return;
      }
      for (int ih = ih0; ih < ih1; ++ih) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < (KH > 0 ? KH : kh); ++i) {
          const int oh = ih + g.plh - i;
          if (oh < G.gr0 || oh >= G.gr1) continue;
#pragma unroll
          for (int j = 0; j < (KW > 0 ? KW : kw); ++j) {
            const int ow = iw + g.plw - j;
            if (ow < 0 || ow >= g.OW) continue;
            const int o = (oh - G.gr0) * g.OW + ow;
            if (tq[o] == i * kw + j) acc += gq[o];
          }
        }
        dq[(ih - G.r0) * g.W] = acc;
      }
    });
    // dx of this group is whole; stage s and the taps are read
    __syncthreads();
    if (threadIdx.x == 0 && gi + (long long)kStages * gridDim.x < g.groups)
      stage_group(x, gy, smem + s * stage, smem + s * stage + g.xbuf,
                  &full[s], g, gi + (long long)kStages * gridDim.x, true);
    store_run(dxdst, dxbuf, G.np * dplane);
  }
}

__device__ __forceinline__ float x_at(const float* __restrict__ xp, int H,
                                      int W, int ih, int iw) {
  return (ih >= 0 && ih < H && iw >= 0 && iw < W) ? xp[(long long)ih * W + iw]
                                                  : -CUDART_INF_F;
}

// The first maximum of the window whose top-left tap `at(0, 0)` names:
// strict >, so the first max wins a tie and a NaN counts only at tap 0.
template <class At>
__device__ __forceinline__ int first_max(At at, int kh, int kw,
                                         float* best_out) {
  float best = at(0, 0);
  int arg = 0;
  for (int i = 0; i < kh; ++i)
    for (int j = 0; j < kw; ++j) {
      const float v = at(i, j);
      if (v > best) {
        best = v;
        arg = i * kw + j;
      }
    }
  *best_out = best;
  return arg;
}

// Unstaged forms, for windows no band of shared memory can hold.
__global__ void __launch_bounds__(256)
    s1_fwd_direct(const float* __restrict__ x, float* __restrict__ y, Geom g) {
  const long long total = g.NC * g.OH * g.OW;
  for (long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       o < total; o += (long long)gridDim.x * blockDim.x) {
    const int ow = (int)(o % g.OW), oh = (int)(o / g.OW % g.OH);
    const float* xp = x + o / ((long long)g.OH * g.OW) * g.H * g.W;
    float best;
    first_max(
        [&](int i, int j) {
          return x_at(xp, g.H, g.W, oh - g.plh + i, ow - g.plw + j);
        },
        g.kh, g.kw, &best);
    y[o] = best;
  }
}

__global__ void __launch_bounds__(256)
    s1_bwd_direct(const float* __restrict__ x, const float* __restrict__ gy,
                  float* __restrict__ dx, Geom g) {
  const long long total = g.NC * g.H * g.W;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int iw = (int)(e % g.W), ih = (int)(e / g.W % g.H);
    const long long nc = e / ((long long)g.H * g.W);
    const float* xp = x + nc * g.H * g.W;
    float acc = 0.0f;
    for (int i = 0; i < g.kh; ++i)
      for (int j = 0; j < g.kw; ++j) {
        const int oh = ih + g.plh - i, ow = iw + g.plw - j;
        if (oh < 0 || oh >= g.OH || ow < 0 || ow >= g.OW) continue;
        float best;
        const int tap = first_max(
            [&](int ti, int tj) {
              return x_at(xp, g.H, g.W, oh - g.plh + ti, ow - g.plw + tj);
            },
            g.kh, g.kw, &best);
        if (tap == i * g.kw + j) acc += gy[(nc * g.OH + oh) * g.OW + ow];
      }
    dx[e] = acc;
  }
}

long long round4(long long n) { return (n + 3) / 4 * 4; }
int strips(int n) { return (n + kStripRows - 1) / kStripRows; }

// Bytes of a first-max tap in the backward's shared array (0: too many
// taps for two bytes).
int tap_bytes(int kh, int kw) {
  const long long taps = (long long)kh * kw;
  return taps <= 256 ? 1 : (taps <= 65536 ? 2 : 0);
}

// Fills the plan's sizes for `planes` planes a group and `rows` rows of
// the pass's output a group (all of them: one band); returns the group's
// tasks.
long long size_plan(Plan* p, long long NC, int H, int W, int OH, int OW,
                    int kh, int kw, bool bwd, int planes, int rows) {
  const int total = bwd ? H : OH;
  const int bands = (total + rows - 1) / rows;
  p->planes = planes;
  p->rows = rows;
  p->bands = bands;
  if (bands == 1) {
    p->xrows = H;
    p->grows = bwd ? OH : 0;
  } else if (!bwd) {
    p->xrows = H < rows + kh - 1 ? H : rows + kh - 1;
    p->grows = 0;
  } else {
    p->grows = OH < rows + kh - 1 ? OH : rows + kh - 1;
    p->xrows = H < p->grows + kh - 1 ? H : p->grows + kh - 1;
  }
  long long tasks = (long long)planes * OW * strips(bwd ? p->grows : rows);
  if (bwd && (long long)planes * W * strips(rows) > tasks)
    tasks = (long long)planes * W * strips(rows);
  p->threads = (int)((tasks < kMaxThreads ? tasks : kMaxThreads) + 31) / 32 *
               32;
  p->groups = (NC + planes - 1) / planes * bands;
  p->xbuf = round4((long long)planes * p->xrows * W + 3);
  p->gbuf = round4((long long)planes * p->grows * OW + 3);
  p->obuf = round4((long long)planes * rows * (bwd ? W : OW) + 3);
  if (!bwd) {
    p->smem = 4 * (kStages * p->xbuf + 2 * p->obuf);
  } else {
    const long long tbytes =
        ((long long)planes * p->grows * OW * tap_bytes(kh, kw) + kAlign - 1) /
        kAlign * kAlign;
    p->smem = 4 * (kStages * (p->xbuf + p->gbuf) + p->obuf) + tbytes;
  }
  return tasks;
}

// Whole planes where one plane's tasks fit a block and its bytes the
// cap, as many as keep the tasks within kMaxThreads; else bands of rows
// (strips of kStripRows rows for as many as fit kMaxThreads across the
// widest row), cut while the bytes exceed the cap, then while they
// exceed a block's most; else the unstaged kernels.
Plan make_plan(long long NC, int H, int W, int OH, int OW, int kh, int kw,
               bool bwd) {
  Plan p = {};
  if (bwd && tap_bytes(kh, kw) == 0) return p;
  const int total = bwd ? H : OH;
  const long long tasks =
      size_plan(&p, NC, H, W, OH, OW, kh, kw, bwd, 1, total);
  if (tasks <= kMaxThreads && p.smem <= (long long)kSmemCap) {
    long long planes = kMaxThreads / tasks;
    if (planes > NC) planes = NC;
    for (;; --planes) {
      size_plan(&p, NC, H, W, OH, OW, kh, kw, bwd, (int)planes, total);
      if (planes == 1 || p.smem <= (long long)kSmemCap) break;
    }
    p.path = kPlanes;
    return p;
  }
  const int cols = bwd && W > OW ? W : OW;
  int first = kStripRows * (kMaxThreads / cols > 1 ? kMaxThreads / cols : 1);
  if (first > total) first = total;
  const size_t caps[2] = {kSmemCap, kSmemMax};
  for (const size_t cap : caps) {
    for (int rows = first;; --rows) {
      size_plan(&p, NC, H, W, OH, OW, kh, kw, bwd, 1, rows);
      if (rows == 1 || p.smem <= (long long)cap) break;
    }
    if (p.smem <= (long long)cap) {
      p.path = kBands;
      return p;
    }
  }
  p.path = kDirect;
  return p;
}

Geom make_geom(const Plan& p, long long NC, int H, int W, int OH, int OW,
               int kh, int kw, int plh, int plw) {
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
  g.P = p.planes;
  g.rows = p.rows;
  g.bands = p.bands;
  g.groups = p.groups;
  g.xbuf = (int)p.xbuf;
  g.gbuf = (int)p.gbuf;
  g.obuf = (int)p.obuf;
  return g;
}

unsigned grid_cap(long long blocks) {
  const long long cap = 1LL << 30;  // blocks loop over the rest
  return (unsigned)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

// Opts the kernel in to `bytes` of shared memory and returns the
// persistent grid: the blocks resident on the card, at most one a group.
template <class K>
cudaError_t persistent_grid(K kernel, const Plan& p, int device,
                            unsigned* grid) {
  cudaError_t err = cudaSuccess;
  if (p.smem > (long long)kSmemDefault)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      p.threads, p.smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  *grid = grid_cap(p.groups < resident ? p.groups : resident);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The plan of a forward (bwd 0) or backward (1) launch, as
// ops/maxpool_s1.py `plan` mirrors it: out[0..7] = path (0 unstaged, 1
// planes, 2 bands), planes, rows, xrows, grows, threads, groups, shared
// bytes.
void bigdl_maxpool2d_s1_plan(long long NC, int H, int W, int OH, int OW,
                             int kh, int kw, int bwd, long long* out) {
  const Plan p = make_plan(NC, H, W, OH, OW, kh, kw, bwd != 0);
  const long long v[8] = {p.path,  p.planes,  p.rows,   p.xrows,
                          p.grows, p.threads, p.groups, p.smem};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
}

// Forward over NC = N * C planes.  Returns the cudaError_t of the launch.
int bigdl_maxpool2d_s1_fwd_f32(const float* x, float* y, long long NC, int H,
                               int W, int OH, int OW, int kh, int kw, int plh,
                               int plw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (NC == 0 || OH == 0 || OW == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(NC, H, W, OH, OW, kh, kw, false);
  const Geom g = make_geom(p, NC, H, W, OH, OW, kh, kw, plh, plw);
  if (p.path == kDirect) {
    const long long total = NC * OH * OW;
    s1_fwd_direct<<<grid_cap((total + 255) / 256), 256, 0, st>>>(x, y, g);
  } else {
    auto kernel = (kh == 3 && kw == 3) ? s1_fwd_staged<3, 3>
                                       : s1_fwd_staged<0, 0>;
    unsigned grid = 0;
    err = persistent_grid(kernel, p, device, &grid);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, p.threads, p.smem, st>>>(x, y, g);
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
  const Plan p = make_plan(NC, H, W, OH, OW, kh, kw, true);
  const Geom g = make_geom(p, NC, H, W, OH, OW, kh, kw, plh, plw);
  if (p.path == kDirect) {
    const long long total = NC * H * W;
    s1_bwd_direct<<<grid_cap((total + 255) / 256), 256, 0, st>>>(x, gy, dx,
                                                                 g);
  } else {
    auto kernel = (kh == 3 && kw == 3) ? s1_bwd_staged<3, 3, uint8_t>
                  : tap_bytes(kh, kw) == 1 ? s1_bwd_staged<0, 0, uint8_t>
                                           : s1_bwd_staged<0, 0, uint16_t>;
    unsigned grid = 0;
    err = persistent_grid(kernel, p, device, &grid);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, p.threads, p.smem, st>>>(x, gy, dx, g);
  }
  return (int)cudaGetLastError();
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
