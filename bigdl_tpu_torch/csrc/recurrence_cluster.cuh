// The thread-block-cluster recurrence: one cluster of C blocks walks all
// T steps of a tile of R batch rows of one direction, the C blocks
// splitting the hidden units (rnn.cu and lstm_scan.cu run on it).
//
// Block k of a cluster owns units [k H / C, (k + 1) H / C) and, for a
// cell of G gates, the G columns of each (an LSTM's i, f, g and o of the
// same unit), so its gate arithmetic and cell state never leave it.  It
// holds its slice of the recurrent weight in shared memory for all T
// steps when it fits, else reads only that slice through L2.  Every
// block keeps the full state (h, or the RNN backward's dz) of its R rows
// in a double-buffered array: its lanes write their new values into its
// own next buffer, and after a block barrier the block copies that slice,
// one contiguous run, into the next buffer of every other block of the
// cluster (distributed shared memory, 16-byte st.shared::cluster); the
// cluster then meets at one barrier a step (release / acquire).  The last
// step's barrier is each block's final one, so no block's shared memory
// is written after it leaves.  Clusters are independent: nothing
// synchronises the grid.  C = 1 is the same template with the block
// barrier alone.  A cluster costs its exchange and barrier every step, so
// the plan takes the smallest C whose blocks hold the weight slice.
//
// Inside a block, a column's H-long dot product is split across KP lanes
// of a warp (lane kp takes m = kp, kp + KP, ...), each lane summing runs
// of kChunk terms from zero, runs of kChunk such runs from zero, then
// their total; the KP partials meet in an xor butterfly of shuffles.
// Every lane of the group then holds the same sums, and lane kp updates
// rows kp, kp + KP, ... of its tile.  The split is a function of the
// shape alone, so the bits are the same every run.
//
// The block's inputs of a step (its units' columns of its rows) are
// prefetched into a ring of `depth` stages in shared memory (cp.async,
// 16 bytes a copy where aligned) depth - 1 steps ahead, so a step waits
// on no device memory; the step's barrier makes them visible.  Outputs
// are coalesced fire-and-forget global stores of the block's new slice.
//
// The plan -- C, R, the lanes a column and the ring's depth -- is a
// function of (cell, D, B, H) alone (`make_plan`), mirrored by
// ops/_recurrence.py `cluster_plan`; a launch that is refused returns its
// cudaError_t, and nothing retries with another plan.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads of a cluster block
constexpr int kMaxSmem = 232448;
constexpr int kMinDepth = 3;    // stages of the prefetch ring, at least
constexpr int kMaxDepth = 8;    // and at most
constexpr int kSms = 132;       // SMs of an H100 SXM, which the rows fill
constexpr int kChunk = 32;      // terms a run (and runs a run of runs)
constexpr int kClusterSizes[] = {1, 2, 4, 8, 16};
constexpr int kRowChoices[] = {1, 2, 4, 8, 16};
constexpr int kMaxAcc = 16;     // rows x gates a lane accumulates

struct Dims {
  int T, D, B, H;
};

// What a cell of the recurrence is, to the cluster block (a policy:
// rnn.cu and lstm_scan.cu define theirs):
//   G          columns (gates) a hidden unit has
//   kIn        input stacks, each (T, D, B, G*H), prefetched per step
//   kReverse   walks t from T - 1 down to 0
//   kHasC      keeps a cell state c (from c0) beside the exchanged one
//   kWeightT   the weight element of (m, column) is w[d][col][m], not
//              w[d][m][col] (the RNN backward reads wht's rows)
//   update(x, z, c) -> the unit's new exchanged value, given its kIn*G
//              prefetched inputs x[a*G + g], its G sums z and its c
struct Args {
  const float* in[2];   // the cell's input stacks
  const float* w;       // (D, H, G*H), or read transposed (kWeightT)
  const float* h0;      // (D, B, H) initial state, null for zeros
  const float* c0;      // (D, B, H) initial cell state (kHasC)
  float* out;           // (T, D, B, H)
  Dims dm;
};

struct Plan {
  int C, R, RT, KP, S, staged, depth, bytes;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

inline int pow2_floor(int x) {
  int p = 1;
  while (p * 2 <= x) p *= 2;
  return p;
}

// rows a lane accumulates in one item: R, at most kMaxAcc / G
inline int row_tile(int R, int G) {
  const int cap = kMaxAcc / G;
  return R < cap ? R : cap;
}

// The weight slice's row stride in shared memory: 4 floats past the
// slice, so the KP lanes of a column read distinct banks.
__host__ __device__ inline int w_stride(int S, int G) { return S * G + 4; }

// Shared memory of a block, in floats, at `depth` ring stages: the two
// state buffers, c, the weight slice when staged, the ring.
inline long long smem_floats(int G, int kIn, bool has_c, int H, int R,
                             int C, bool staged, int depth) {
  const long long S = (H + C - 1) / C;
  return 2LL * round4(H * R) + (has_c ? round4((int)(R * S)) : 0) +
         (staged ? ((long long)H * w_stride((int)S, G) + 3) / 4 * 4 : 0) +
         depth * (long long)round4((int)(kIn * G * R * S));
}

// The plan of (C, R) for a cell at (D, B, H), or C = 0 when it does not
// fit: the weight slice staged when it fits beside the shallowest ring,
// the ring as deep as the rest leaves room for (kMinDepth to kMaxDepth).
inline Plan plan_at(int G, int kIn, bool has_c, int H, int R, int C) {
  Plan p{0, R, row_tile(R, G), 1, (H + C - 1) / C, 0, 0, 0};
  const long long cap = kMaxSmem / 4;
  if (C > H) return p;
  const long long stage = round4(kIn * G * R * p.S);
  long long fixed = smem_floats(G, kIn, has_c, H, R, C, true, 0);
  p.staged = fixed + kMinDepth * stage <= cap;
  if (!p.staged) fixed = smem_floats(G, kIn, has_c, H, R, C, false, 0);
  if (fixed + kMinDepth * stage > cap) return p;
  const long long depth = (cap - fixed) / stage;
  p.depth = depth < kMaxDepth ? (int)depth : kMaxDepth;
  p.bytes = (int)(4 * (fixed + p.depth * stage));
  const int items = p.S * (R / p.RT);
  int kp = kThreads / items;
  if (kp > 32) kp = 32;
  if (kp > H) kp = H;
  p.KP = pow2_floor(kp < 1 ? 1 : kp);
  p.C = C;
  return p;
}

// The fewest batch rows a cluster whose D x ceil(B / R) clusters of C
// blocks fit the card's SMs side by side (16 when none do).
inline int fill_rows(int D, int B, int C) {
  for (int R : kRowChoices)
    if ((long long)D * ((B + R - 1) / R) * C <= kSms) return R;
  return kRowChoices[4];
}

// The plan of a cell at (D, B, H): the smallest cluster whose blocks hold
// their weight slice in shared memory, with the fewest rows a cluster that
// fill the SMs; where no cluster holds it, 16 blocks reading their slices
// through L2, with as many of those rows as fit.  A cluster buys on-chip
// weight at the price of a DSMEM exchange and a cluster barrier a step,
// so a cluster takes no more blocks than its weight needs.  C = 0 when
// nothing fits.
inline Plan make_plan(int G, int kIn, bool has_c, int D, int B, int H) {
  for (int C : kClusterSizes) {
    const Plan p = plan_at(G, kIn, has_c, H, fill_rows(D, B, C), C);
    if (p.C != 0 && p.staged) return p;
  }
  for (int R = fill_rows(D, B, 16); R >= 1; R /= 2) {
    const Plan p = plan_at(G, kIn, has_c, H, R, 16);
    if (p.C != 0) return p;
  }
  return Plan{0, 0, 0, 0, 0, 0, 0, 0};
}

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared-memory address of `p` in block `rank` of the cluster.
__device__ __forceinline__ unsigned map_rank(const float* p, unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(unsigned addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void st_cluster4(unsigned addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The RT values a[0..RT) of a 4 * RT-byte aligned row.
template <int RT>
__device__ __forceinline__ void load_rt(const float* a, float (&v)[RT]) {
  if constexpr (RT % 4 == 0) {
#pragma unroll
    for (int q = 0; q < RT / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(a)[q];
      v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
  } else if constexpr (RT == 2) {
    const float2 f = *reinterpret_cast<const float2*>(a);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = a[0];
  }
}

// The G weights w[g] = wp[g * gs] of a unit at one reduction index, from
// shared memory (STAGED) or through L2.
template <int G, bool STAGED>
__device__ __forceinline__ void load_w(const float* wp, int gs,
                                       float (&w)[G]) {
  if constexpr (STAGED && G == 4) {
    const float4 f = *reinterpret_cast<const float4*>(wp);
    w[0] = f.x; w[1] = f.y; w[2] = f.z; w[3] = f.w;
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) w[g] = STAGED ? wp[g] : __ldg(wp + g * gs);
  }
}

// acc[r][g] += sum over this lane's nm terms of h[r] * w[g], the term
// i's h row at hp + i * hstep and its weights at wp + i * wstep (stride
// gs between gates): runs of kChunk terms summed from zero, runs of
// kChunk runs from zero, then their total.  Terms are loaded U at a time
// before their multiply-adds, which keep the order of i.
template <int G, int RT, bool STAGED>
__device__ __forceinline__ void lane_dot(const float* hp, int hstep,
                                         const float* wp, int wstep, int gs,
                                         int nm, float (&acc)[RT][G]) {
  constexpr int U = G + RT <= 4 ? 8 : (G + RT <= 8 ? 4 : 2);
  for (int s0 = 0; s0 < nm; s0 += kChunk * kChunk) {
    const int s1 = min(s0 + kChunk * kChunk, nm);
    float mid[RT][G] = {};
    for (int c0 = s0; c0 < s1; c0 += kChunk) {
      const int c1 = min(c0 + kChunk, s1);
      float part[RT][G] = {};
      int i = c0;
      for (; i + U <= c1; i += U) {
        float w[U][G], h[U][RT];
#pragma unroll
        for (int q = 0; q < U; ++q) {
          load_w<G, STAGED>(wp + q * wstep, gs, w[q]);
          load_rt<RT>(hp + q * hstep, h[q]);
        }
#pragma unroll
        for (int q = 0; q < U; ++q)
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int g = 0; g < G; ++g)
              part[r][g] = fmaf(h[q][r], w[q][g], part[r][g]);
        hp += U * hstep;
        wp += U * wstep;
      }
      for (; i < c1; ++i) {
        float w[G], h[RT];
        load_w<G, STAGED>(wp, gs, w);
        load_rt<RT>(hp, h);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int g = 0; g < G; ++g) part[r][g] = fmaf(h[r], w[g], part[r][g]);
        hp += hstep;
        wp += wstep;
      }
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int g = 0; g < G; ++g) mid[r][g] += part[r][g];
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int g = 0; g < G; ++g) acc[r][g] += mid[r][g];
  }
}

// The cluster recurrence of `Cell` at the plan's RT (a template
// argument) and weight placement (STAGED: in shared memory).
//
// A step: each lane's product, its group's butterfly and the owners'
// updates into the block's own next state buffer; one block barrier;
// then (C > 1) the block's new slice, a contiguous run of that buffer,
// pushed to every other block in 16-byte stores, and the cluster
// barrier's arrive; then, under the barrier, the slice's coalesced store
// to `out` and the prefetch of step s + depth - 1; then the barrier's
// wait.  The stores and the prefetch come after the arrive because its
// release waits for this thread's pending global writes.
template <class Cell, int RT, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1)
    cluster_recurrence(Args a, Plan p) {
  constexpr int G = Cell::G, E = Cell::kIn * Cell::G;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Dims dm = a.dm;
  const int H = dm.H, R = p.R, C = p.C, S = p.S, KP = p.KP, P = p.depth;
  const int tid = threadIdx.x;
  const unsigned k = C > 1 ? cluster_rank() : 0;
  const int cl = blockIdx.x / C, tiles = (dm.B + R - 1) / R;
  const int d = cl / tiles, b0 = (cl % tiles) * R;
  const int rows = min(R, dm.B - b0);
  const int u0 = (int)((long long)k * H / C);
  const int sb = (int)((long long)(k + 1) * H / C) - u0;   // units owned
  const int ws = w_stride(S, G), hstride = round4(H * R);
  float* hb = smem;                                  // [2][H][R]
  float* c_s = hb + 2 * hstride;                     // [R][S]
  float* w_s = c_s + (Cell::kHasC ? round4(R * S) : 0);   // [H][ws]
  float* ring = w_s + (STAGED ? round4(H * ws) : 0);  // [P][E][R][S]
  const int stage = round4(E * R * S);
  const float* W = a.w + (size_t)d * H * G * H;
  const size_t gstride = (size_t)G * H;

  // h0 (or zeros), c0 and the weight slice join step 0's copy group
  for (int e = tid; e < H * R; e += kThreads) {
    const int u = e / R, r = e - u * R;
    if (a.h0 != nullptr && r < rows) {
      cp_async4(hb + e, a.h0 + ((size_t)d * dm.B + b0 + r) * H + u);
    } else {
      hb[e] = 0.0f;
    }
  }
  if constexpr (Cell::kHasC) {
    for (int e = tid; e < R * S; e += kThreads) {
      const int r = e / S, j = e - r * S;
      if (r < rows && j < sb) {
        cp_async4(c_s + e, a.c0 + ((size_t)d * dm.B + b0 + r) * H + u0 + j);
      } else {
        c_s[e] = 0.0f;
      }
    }
  }
  if constexpr (STAGED) {
    for (int e = tid; e < H * S * G; e += kThreads) {
      const int m = e / (S * G), jg = e - m * S * G;
      const int j = jg / G, g = jg - j * G;
      const int u = u0 + j;
      float* dst = w_s + (size_t)m * ws + jg;
      if (j < sb) {
        cp_async4(dst, Cell::kWeightT ? W + (size_t)(g * H + u) * H + m
                                      : W + (size_t)m * G * H + g * H + u);
      } else {
        *dst = 0.0f;
      }
    }
  }

  // the block's inputs of step s into ring stage `stg`: E x rows runs of
  // sb floats, in 16-byte copies where aligned; read after a barrier
  const bool vec = ((S | H | u0 | sb) & 3) == 0;
  const int per = vec ? sb / 4 : sb, copies = E * rows * per;
  auto prefetch = [&](int s, float* stg) {
    if (s < dm.T) {
      const int t = Cell::kReverse ? dm.T - 1 - s : s;
      const size_t row0 = ((size_t)t * dm.D + d) * dm.B + b0;
      for (int e = tid; e < copies; e += kThreads) {
        const int qr = e / per, i = e - qr * per;
        const int q = qr / rows, r = qr - q * rows;
        const int ai = q / G, g = q - ai * G;
        const float* src = (ai == 0 ? a.in[0] : a.in[1]) +
                           (row0 + r) * gstride + (size_t)g * H + u0;
        float* dst = stg + ((size_t)q * R + r) * S;
        if (vec) {
          cp_async16(dst + 4 * i, src + 4 * i);
        } else {
          cp_async4(dst + i, src + i);
        }
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < P - 1; ++s) prefetch(s, ring + (size_t)s * stage);
  cp_async_wait(P - 2);   // the state, the weight and step 0's inputs
  __syncthreads();
  if (C > 1) {   // every block of the cluster has started
    cluster_arrive();
    cluster_wait();
  }

  // lanes: kp splits a column's sum, slot picks the items (unit j, row
  // tile rt0), `rounds` of them; every thread walks the same rounds, so
  // the butterfly's shuffles see whole warps
  const int kp = tid % KP, slot = tid / KP, slots = kThreads / KP;
  const int rounds = (S * (R / RT) + slots - 1) / slots;
  const int j_first = slot % S, tile_first = slot / S;
  // a lane's weight steps: between its terms, and between gates
  const int wstep = STAGED ? KP * ws : (Cell::kWeightT ? KP : KP * G * H);
  const int gs = STAGED ? 1 : (Cell::kWeightT ? H * H : H);
  const int j_step = slots % S, tile_step = slots / S;
  const int base = u0 * R, n = sb * R;   // this block's slice of a buffer
  const int n4 = (base & 3) == 0 ? n / 4 : 0;
  int ps = 0, pf = P - 1;   // ring stages of steps s and s + P - 1
  for (int s = 0; s < dm.T; ++s) {
    const int t = Cell::kReverse ? dm.T - 1 - s : s;
    const float* cur = hb + (size_t)(s & 1) * hstride;
    float* nxt = hb + (size_t)((s + 1) & 1) * hstride;
    const float* st = ring + (size_t)ps * stage;
    int j = j_first, rt0 = tile_first * RT;
    for (int round = 0; round < rounds; ++round) {
      const bool live = rt0 < R && j < sb;
      float acc[RT][G] = {};
      if (live && kp < H) {
        const int u = u0 + j;
        const float* wp =
            STAGED ? w_s + kp * ws + j * G
                   : (Cell::kWeightT ? W + (size_t)u * H + kp
                                     : W + (size_t)kp * G * H + u);
        lane_dot<G, RT, STAGED>(cur + kp * R + rt0, KP * R, wp, wstep, gs,
                                (H - kp + KP - 1) / KP, acc);
      }
      for (int o = KP / 2; o >= 1; o >>= 1)
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
          for (int g = 0; g < G; ++g)
            acc[r][g] += __shfl_xor_sync(0xffffffffu, acc[r][g], o);
      if (live) {
#pragma unroll
        for (int rr = 0; rr < RT; ++rr) {
          const int r = rt0 + rr;
          if ((rr & (KP - 1)) != kp) continue;
          float v = 0.0f;
          if (r < rows) {
            float x[E];
#pragma unroll
            for (int q = 0; q < E; ++q) x[q] = st[((size_t)q * R + r) * S + j];
            float c = 0.0f;
            if constexpr (Cell::kHasC) c = c_s[r * S + j];
            v = Cell::update(x, acc[rr], c);
            if constexpr (Cell::kHasC) c_s[r * S + j] = c;
          }
          nxt[(size_t)(u0 + j) * R + r] = v;
        }
      }
      j += j_step;
      rt0 += tile_step * RT;
      if (j >= S) {
        j -= S;
        rt0 += RT;
      }
    }
    cp_async_wait(P - 3);   // step s + 1's inputs, issued P - 2 steps ago
    __syncthreads();
    if (C > 1) {
      for (int e = tid; e < n4 * (C - 1); e += kThreads) {
        const int q = e / n4, i = e - q * n4;
        const float* v4 = nxt + base + 4 * i;
        st_cluster4(map_rank(v4, q >= (int)k ? q + 1 : q),
                    *reinterpret_cast<const float4*>(v4));
      }
      const int tail = n - 4 * n4;
      for (int e = tid; e < tail * (C - 1); e += kThreads) {
        const int q = e / tail, i = e - q * tail;
        const float* v1 = nxt + base + 4 * n4 + i;
        st_cluster(map_rank(v1, q >= (int)k ? q + 1 : q), *v1);
      }
      cluster_arrive();
    }
    for (int e = tid; e < rows * sb; e += kThreads) {
      const int r = e / sb, jj = e - r * sb;
      a.out[(((size_t)t * dm.D + d) * dm.B + b0 + r) * H + u0 + jj] =
          nxt[(size_t)(u0 + jj) * R + r];
    }
    prefetch(s + P - 1, ring + (size_t)pf * stage);
    if (C > 1) cluster_wait();
    ps = ps + 1 == P ? 0 : ps + 1;
    pf = pf + 1 == P ? 0 : pf + 1;
  }
}

inline cudaError_t set_attrs(const void* fn, int bytes, int C) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess || C <= 8) return err;
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// One launch of the cluster recurrence of `Cell` under plan `p`: the
// grid is D x ceil(B / R) clusters of C blocks (C = 1: a plain launch).
// The first launch of a (kernel, C > 1, bytes) checks that at least one
// such cluster can be resident; a refused launch returns its error.
template <class Cell, int RT, bool STAGED>
cudaError_t launch_cluster(const Args& a, const Plan& p, cudaStream_t st) {
  const void* fn = (const void*)cluster_recurrence<Cell, RT, STAGED>;
  cudaError_t err = set_attrs(fn, p.bytes, p.C);
  if (err != cudaSuccess) return err;
  const Dims& dm = a.dm;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(dm.D * ((dm.B + p.R - 1) / p.R) * p.C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)p.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.C > 1 ? 1 : 0;   // C = 1: a plain launch
  static thread_local struct { const void* fn; int C, bytes; } seen[32];
  static thread_local int n_seen = 0;
  bool known = p.C == 1;
  for (int i = 0; i < n_seen; ++i)
    known |= seen[i].fn == fn && seen[i].C == p.C && seen[i].bytes == p.bytes;
  if (!known) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    if (n_seen < 32) seen[n_seen++] = {fn, p.C, p.bytes};
  }
  err = cudaLaunchKernelEx(&cfg, cluster_recurrence<Cell, RT, STAGED>, a, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch at the plan's RT and weight placement; RT is R capped at
// kMaxAcc / G.
template <class Cell, int RT>
cudaError_t launch_rt(const Args& a, const Plan& p, cudaStream_t st) {
  if constexpr (RT * Cell::G <= kMaxAcc) {
    return p.staged ? launch_cluster<Cell, RT, true>(a, p, st)
                    : launch_cluster<Cell, RT, false>(a, p, st);
  }
  return cudaErrorInvalidValue;
}

template <class Cell>
cudaError_t launch_planned(const Args& a, const Plan& p, cudaStream_t st) {
  if (p.C == 0) return cudaErrorInvalidValue;
  switch (p.RT) {
    case 1: return launch_rt<Cell, 1>(a, p, st);
    case 2: return launch_rt<Cell, 2>(a, p, st);
    case 4: return launch_rt<Cell, 4>(a, p, st);
    case 8: return launch_rt<Cell, 8>(a, p, st);
    case 16: return launch_rt<Cell, 16>(a, p, st);
  }
  return cudaErrorInvalidValue;
}

inline bool empty(const Dims& dm) {
  return dm.T == 0 || dm.D == 0 || dm.B == 0 || dm.H == 0;
}

}  // namespace
