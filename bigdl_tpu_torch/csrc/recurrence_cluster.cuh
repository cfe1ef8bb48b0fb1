// The thread-block-cluster recurrence: one cluster of C blocks walks all
// T steps of a tile of R batch rows of one direction, the C blocks
// splitting the hidden units (rnn.cu, bilstm.cu and gru.cu run on it).
//
// Block k of a cluster owns units [k H / C, (k + 1) H / C) and, for a
// cell of G gates, the G columns of each (an LSTM's i, f, g and o of the
// same unit), so its gate arithmetic and local values (an LSTM's c) never
// leave it.  It holds its slice of the recurrent weight in shared memory
// for all T steps when it fits, else reads only that slice through L2.
// Every block keeps the full state of its R rows -- V values a unit: h
// (V = 1), the RNN backward's dz (1) or the LSTM backward's four gates' dz
// (4) -- unit-major, [u][v][R], in a double-buffered array: its lanes
// write their new values into its own next buffer, and after a block
// barrier the block copies that slice, one contiguous run, into the next
// buffer of every other block of the cluster (distributed shared memory,
// 16-byte st.shared::cluster); the
// cluster then meets at one barrier a step (release / acquire).  The last
// step's barrier is each block's final one, so no block's shared memory
// is written after it leaves.  Clusters are independent: nothing
// synchronises the grid.  C = 1 is the same template with the block
// barrier alone.  A cluster costs its exchange and barrier every step, so
// the plan takes the smallest C whose blocks hold the weight slice.
//
// A cell whose step is two dependent products (the GRU's h . wrz, then
// (r o h) . wh) declares two phases.  A step runs phase 0, then phase 1;
// each is a product over the state the other phase last exchanged (phase
// 0 of step 0: the initial state), with its own gates, weight and weight
// slice, then the owners' update, then the exchange of the phase's own
// state with its own block barrier and, where C > 1, its own push and
// cluster barrier.  Each phase's state has one buffer: the other phase's
// barrier lies between its reads and its next writes, in every block of
// the cluster.  What one phase hands the other for the same unit and row
// stays in the owning block as the cell's L local values.  A one-phase
// cell is the same template with its state in two buffers.
//
// Inside a block, a column's product over the H units of the state (V
// terms each) is split across KP lanes of a warp (lane kp takes units m =
// kp, kp + KP, ...), each lane summing runs of kChunk units from zero,
// runs of kChunk such runs from zero, then their total; the KP partials
// meet in an xor butterfly of shuffles.
// Every lane of the group then holds the same sums, and lane kp updates
// rows kp, kp + KP, ... of its tile.  The split is a function of the
// shape alone, so the bits are the same every run.
//
// The block's inputs of a step (its units' columns of its rows, from
// stacks of different widths and, for an input of step t - 1, another
// time) are prefetched into a ring of `depth` stages in shared memory
// (cp.async, 16 bytes a copy where aligned) depth - 1 steps ahead, so a
// step waits on no device memory; the step's barrier makes them visible.
// Outputs are coalesced fire-and-forget global stores of the block's new
// slice and, where asked, of its cell state.
//
// The plan -- C, R, the lanes a column and the ring's depth -- is a
// function of (cell, D, B, H) alone (`make_plan`), mirrored by
// ops/_recurrence.py `cluster_plan`; a launch that is refused returns its
// cudaError_t, and nothing retries with another plan.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;   // threads of a cluster block
constexpr int kMaxSmem = 232448;
constexpr int kMinDepth = 3;    // stages of the prefetch ring, at least
constexpr int kMaxDepth = 8;    // and at most
constexpr int kSms = 132;       // SMs of an H100 SXM, which the rows fill
constexpr int kChunk = 32;      // terms a run (and runs a run of runs)
constexpr int kClusterSizes[] = {1, 2, 4, 8, 16};
constexpr int kRowChoices[] = {1, 2, 4, 8, 16};
constexpr int kMaxAcc = 16;     // rows x gates x values a lane holds

struct Dims {
  int T, D, B, H;
};

// Where input q of a unit comes from: value v of the unit's `width`
// values (at v * H + u) of stack `a`, a (T, D, B, width * H) array, at
// step t + shift (zeros outside [0, T)).
struct In {
  int a, v, width, shift;
};

// What a cell of the recurrence is, to the cluster block (a policy:
// rnn.cu, bilstm.cu and gru.cu define theirs).  A one-phase cell:
//   G          columns (gates) of a hidden unit's product
//   V          values a unit holds in the exchanged state; the product
//              of a column sums over every unit's V values
//   E          inputs a unit takes a step, input(q) saying from where
//   kReverse   walks t from T - 1 down to 0
//   kHasC      keeps a cell state c (from c0, or zeros) beside the
//              exchanged one
//   kWeightT   (G = 1) the weight of state value (m, v) for unit u is
//              w[d][u][v*H + m], not w[d][m][g*H + u] (V = 1): a
//              backward reads wht's rows in place
//   update(x, z, c, y) -> y[0..V), the unit's new exchanged values,
//              given its E prefetched inputs x, its G sums z and its c
// A one-phase cell that declares kAct (rnn.cu's) is handed the launch's
// activation as update(act, x, z, c, y).
// A two-phase cell has E, kReverse, input(q), kHasC = false, L local
// values a unit (zeros at the start, but local value kLocalH0, where it
// is not -1, from h0) and two phases P0 and P1, each with G, kWeightT
// and V, the values it exchanges; a phase's product sums over the other
// phase's V values a unit, and its update(x, z, loc, y) may read and
// write the unit's L local values.
struct Args {
  const float* in[4];   // the cell's input stacks
  const float* w;       // (D, H, G*V*H): wht, read transposed (kWeightT);
                        // a two-phase cell's phase 0 weight
  const float* h0;      // (D, B, H) initial state (V = 1), null for zeros
  const float* c0;      // (D, B, H) initial cell state, null for zeros
  float* out;           // (T, D, B, V*H): the state, value v at v*H + u
                        // (a two-phase cell: phase 1's)
  float* cout;          // (T, D, B, H) the cell state (kHasC), or null
  Dims dm;
  const float* w1;      // a two-phase cell's phase 1 weight
  float* mid;           // (T, D, B, V*H) its phase 0 state, or null
  const float* prev0;   // (D, B, width*H): what an input reads at a step
                        // before 0 (a carried c0 or h0), null for zeros
};

// An element-wise activation: a kind (rnn.cu's codes) and up to three
// parameters.  Cells without kAct ignore it.
struct Act {
  int kind;
  float a, b, c;
};

// Whether an input of `Cell` is read a step back (and so may read prev0).
template <class Cell>
__host__ __device__ constexpr bool reads_prev() {
  for (int q = 0; q < Cell::E; ++q)
    if (Cell::input(q).shift < 0) return true;
  return false;
}

template <class Cell, class = void>
struct TakesAct : std::false_type {};

template <class Cell>
struct TakesAct<Cell, std::void_t<decltype(Cell::kAct)>> : std::true_type {};

struct Plan {
  int C, R, RT, KP, S, staged, depth, bytes;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

inline int pow2_floor(int x) {
  int p = 1;
  while (p * 2 <= x) p *= 2;
  return p;
}

// rows a lane takes in one item: R, at most kMaxAcc / (G * V)
inline int row_tile(int R, int GV) {
  const int cap = kMaxAcc / GV;
  return R < cap ? R : cap;
}

// The weight slice's row stride in shared memory: 4 floats past the
// slice, so the KP lanes of a column read distinct banks.
__host__ __device__ inline int w_stride(int S, int G) { return S * G + 4; }

template <class T>
struct Tag {
  using type = T;
};

// A cell's phases: a one-phase cell is its own phase 0 and 1 (its local
// value is c where kHasC); a two-phase cell names P0 and P1.  Phase 0's
// product reads P1::V values a unit, phase 1's P0::V.
template <class Cell, class = void>
struct Phases {
  using P0 = Cell;
  using P1 = Cell;
  static constexpr int n = 1, L = Cell::kHasC ? 1 : 0;
  static constexpr int kH0 = -1;
};

template <class Cell>
struct Phases<Cell, std::void_t<typename Cell::P1>> {
  using P0 = typename Cell::P0;
  using P1 = typename Cell::P1;
  static constexpr int n = 2, L = Cell::L;
  static constexpr int kH0 = Cell::kLocalH0;
};

// the weights a unit takes at one reduction index, in phase 0 and 1, and
// the larger: a lane's accumulators a row
template <class Cell>
__host__ __device__ constexpr int weights0() {
  using Ps = Phases<Cell>;
  return Ps::P0::G * Ps::P1::V;
}
template <class Cell>
__host__ __device__ constexpr int weights1() {
  using Ps = Phases<Cell>;
  return Ps::P1::G * Ps::P0::V;
}
template <class Cell>
__host__ __device__ constexpr int max_gv() {
  return weights0<Cell>() > weights1<Cell>() ? weights0<Cell>()
                                             : weights1<Cell>();
}

// Shared memory of a block of `Cell`, in floats, at `depth` ring
// stages: the states (one phase: two buffers), the local values, the
// weight slices when staged, the ring.
template <class Cell>
inline long long smem_floats(int H, int R, int C, bool staged, int depth) {
  using Ps = Phases<Cell>;
  const long long S = (H + C - 1) / C;
  const auto slice = [&](int gv) {
    return ((long long)H * w_stride((int)S, gv) + 3) / 4 * 4;
  };
  return round4(Ps::P0::V * H * R) + round4(Ps::P1::V * H * R) +
         round4((int)(Ps::L * R * S)) +
         (staged ? slice(weights0<Cell>()) +
                       (Ps::n == 2 ? slice(weights1<Cell>()) : 0)
                 : 0) +
         depth * (long long)round4((int)(Cell::E * R * S));
}

// The plan of (C, R) for `Cell` at H, or C = 0 when it does not fit: the
// weight slice staged when it fits beside the shallowest ring, the ring
// as deep as the rest leaves room for (kMinDepth to kMaxDepth).
template <class Cell>
inline Plan plan_at(int H, int R, int C) {
  Plan p{0, R, row_tile(R, max_gv<Cell>()), 1, (H + C - 1) / C, 0, 0, 0};
  const long long cap = kMaxSmem / 4;
  if (C > H) return p;
  const long long stage = round4(Cell::E * R * p.S);
  long long fixed = smem_floats<Cell>(H, R, C, true, 0);
  p.staged = fixed + kMinDepth * stage <= cap;
  if (!p.staged) fixed = smem_floats<Cell>(H, R, C, false, 0);
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
template <class Cell>
inline Plan make_plan(int D, int B, int H) {
  for (int C : kClusterSizes) {
    const Plan p = plan_at<Cell>(H, fill_rows(D, B, C), C);
    if (p.C != 0 && p.staged) return p;
  }
  for (int R = fill_rows(D, B, 16); R >= 1; R /= 2) {
    const Plan p = plan_at<Cell>(H, R, 16);
    if (p.C != 0) return p;
  }
  return Plan{0, 0, 0, 0, 0, 0, 0, 0};
}

// The plan of the shape, or with C > 0 the plan at (C, R) (C = 0 in it
// when that does not fit): recurrence_plans.py times them all.
template <class Cell>
Plan plan_of(int D, int B, int H, int C = 0, int R = 0) {
  return C > 0 ? plan_at<Cell>(H, R, C) : make_plan<Cell>(D, B, H);
}

// A plan into out[8]: C, R, RT, KP, S, staged, depth, bytes.
inline void plan_out(const Plan& p, int* out) {
  const int v[8] = {p.C, p.R, p.RT, p.KP, p.S, p.staged, p.depth, p.bytes};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
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

// The N weights w[n] = wp[n * gs] of a unit at one reduction index (n =
// g * V + v), from shared memory (STAGED, gs = 1) or through L2.
template <int N, bool STAGED>
__device__ __forceinline__ void load_w(const float* wp, int gs,
                                       float (&w)[N]) {
  if constexpr (STAGED && N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(wp);
    w[0] = f.x; w[1] = f.y; w[2] = f.z; w[3] = f.w;
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) w[n] = STAGED ? wp[n] : __ldg(wp + n * gs);
  }
}

// acc[r][g] += sum over this lane's nm units and their V values of
// h[v][r] * w[g * V + v], the unit i's state rows at hp + i * hstep (value
// v at + v * vstep) and its weights at wp + i * wstep (stride gs between
// them): runs of kChunk units summed from zero, runs of kChunk runs from
// zero, then their total.  Units are loaded U at a time before their
// multiply-adds, which keep the order of i, then v.
template <int G, int V, int RT, bool STAGED>
__device__ __forceinline__ void lane_dot(const float* hp, int hstep,
                                         int vstep, const float* wp,
                                         int wstep, int gs, int nm,
                                         float (&acc)[RT][G]) {
  constexpr int N = G * V, L = N + V * RT;   // values loaded a unit
  constexpr int U = L <= 4 ? 8 : (L <= 8 ? 4 : 2);
  for (int s0 = 0; s0 < nm; s0 += kChunk * kChunk) {
    const int s1 = min(s0 + kChunk * kChunk, nm);
    float mid[RT][G] = {};
    for (int c0 = s0; c0 < s1; c0 += kChunk) {
      const int c1 = min(c0 + kChunk, s1);
      float part[RT][G] = {};
      int i = c0;
      for (; i + U <= c1; i += U) {
        float w[U][N], h[U][V][RT];
#pragma unroll
        for (int q = 0; q < U; ++q) {
          load_w<N, STAGED>(wp + q * wstep, gs, w[q]);
#pragma unroll
          for (int v = 0; v < V; ++v)
            load_rt<RT>(hp + q * hstep + v * vstep, h[q][v]);
        }
#pragma unroll
        for (int q = 0; q < U; ++q)
#pragma unroll
          for (int v = 0; v < V; ++v)
#pragma unroll
            for (int r = 0; r < RT; ++r)
#pragma unroll
              for (int g = 0; g < G; ++g)
                part[r][g] = fmaf(h[q][v][r], w[q][g * V + v], part[r][g]);
        hp += U * hstep;
        wp += U * wstep;
      }
      for (; i < c1; ++i) {
        float w[N], h[V][RT];
        load_w<N, STAGED>(wp, gs, w);
#pragma unroll
        for (int v = 0; v < V; ++v) load_rt<RT>(hp + v * vstep, h[v]);
#pragma unroll
        for (int v = 0; v < V; ++v)
#pragma unroll
          for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int g = 0; g < G; ++g)
              part[r][g] = fmaf(h[v][r], w[g * V + v], part[r][g]);
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
// A phase of a step: each lane's product, its group's butterfly and the
// owners' updates into the phase's next state (and, where c is stored,
// the new c into its row's slot of input 0 in the ring stage just read);
// one block barrier; then (C > 1) the block's new slice, a contiguous run
// of that state, pushed to every other block in 16-byte stores, and the
// cluster barrier's arrive; then, under the barrier, the slice's
// coalesced store to its output (and c's to `cout`) and, after a step's
// last phase, the prefetch of step s + depth - 1; then the barrier's
// wait.  The stores and the prefetch come after the arrive because its
// release waits for this thread's pending global writes.  The stage the
// c stack is read from is next written by the prefetch of step s + 1,
// after that step's block barrier, so after every thread's stores.
template <class Cell, int RT, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1)
    cluster_recurrence(Args a, Plan p, Act act) {
  using Ps = Phases<Cell>;
  using P0 = typename Ps::P0;
  using P1 = typename Ps::P1;
  constexpr int NP = Ps::n, E = Cell::E, L = Ps::L;
  static_assert((P0::V == 1 || P1::kWeightT) && (P1::V == 1 || P0::kWeightT),
                "a product over V > 1 values a unit reads the weight's rows");
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
  const int ws0 = w_stride(S, weights0<Cell>());
  const int ws1 = w_stride(S, weights1<Cell>());
  // s1: the state phase 0 reads ([u][v][R]); s0: the state phase 0
  // writes.  One phase: two buffers of one state, step s reading s1 where
  // s is even and s0 where it is odd.
  float* s1 = smem;
  float* s0 = s1 + round4(P1::V * H * R);
  float* loc_s = s0 + round4(P0::V * H * R);                // [L][R][S]
  float* w0_s = loc_s + round4(L * R * S);                  // [H][ws0]
  float* w1_s = w0_s + (STAGED ? round4(H * ws0) : 0);      // [H][ws1]
  float* ring = w1_s + (STAGED && NP == 2 ? round4(H * ws1) : 0);
  const int stage = round4(E * R * S);                      // [P][E][R][S]
  const float* W0 = a.w + (size_t)d * H * weights0<Cell>() * H;
  const float* W1 =
      NP == 2 ? a.w1 + (size_t)d * H * weights1<Cell>() * H : W0;

  // h0 (or zeros), the local values from c0 or h0 (or zeros) and the
  // weight slices join step 0's copy group
  for (int e = tid; e < P1::V * H * R; e += kThreads) {
    const int u = e / R, r = e - u * R;   // V = 1 where h0 is given
    if (P1::V == 1 && a.h0 != nullptr && r < rows) {
      cp_async4(s1 + e, a.h0 + ((size_t)d * dm.B + b0 + r) * H + u);
    } else {
      s1[e] = 0.0f;
    }
  }
  for (int e = tid; e < L * R * S; e += kThreads) {
    const int lr = e / S, j = e - lr * S, l = lr / R, r = lr - l * R;
    const float* init = Cell::kHasC && l == 0 ? a.c0
                        : (l == Ps::kH0 ? a.h0 : nullptr);   // c: l = 0
    if (init != nullptr && r < rows && j < sb) {
      cp_async4(loc_s + e, init + ((size_t)d * dm.B + b0 + r) * H + u0 + j);
    } else {
      loc_s[e] = 0.0f;
    }
  }
  // phase `ph`'s weight slice, reading the values of phase `pr`'s state
  const auto stage_w = [&](auto ph, auto pr, const float* W, float* w_s,
                           int ws) {
    using Ph = typename decltype(ph)::type;
    constexpr int G = Ph::G, V = decltype(pr)::type::V, N = G * V;
    for (int e = tid; e < H * S * N; e += kThreads) {
      const int m = e / (S * N), jn = e - m * S * N;
      const int j = jn / N, n = jn - j * N;
      const int g = n / V, v = n - g * V;
      const int u = u0 + j;
      float* dst = w_s + (size_t)m * ws + jn;
      if (j < sb) {
        cp_async4(dst, Ph::kWeightT
                           ? W + (size_t)(g * H + u) * (V * H) + v * H + m
                           : W + (size_t)m * G * H + g * H + u);
      } else {
        *dst = 0.0f;
      }
    }
  };
  if constexpr (STAGED) {
    stage_w(Tag<P0>{}, Tag<P1>{}, W0, w0_s, ws0);
    if constexpr (NP == 2) stage_w(Tag<P1>{}, Tag<P0>{}, W1, w1_s, ws1);
  }

  // the block's inputs of step s into ring stage `stg`: E x rows runs of
  // sb floats, in 16-byte copies where aligned, zeros for an input whose
  // step is outside [0, T) (prev0 for one before 0, where given); read
  // after a barrier.  a.in[in.a] with a
  // runtime stack copies Args to local memory (88 bytes of stack in the
  // backward cells); unrolling over q, or a select, measured slower
  const bool vec = ((S | H | u0 | sb) & 3) == 0;
  const int per = vec ? sb / 4 : sb, copies = E * rows * per;
  constexpr bool kReadsPrev = reads_prev<Cell>();
  auto prefetch = [&](int s, float* stg) {
    if (s < dm.T) {
      const int t = Cell::kReverse ? dm.T - 1 - s : s;
      for (int e = tid; e < copies; e += kThreads) {
        const int qr = e / per, i = e - qr * per;
        const int q = qr / rows, r = qr - q * rows;
        const In in = Cell::input(q);
        int ti = t + in.shift;
        float* dst = stg + ((size_t)q * R + r) * S + (vec ? 4 * i : i);
        const float* stack = a.in[in.a];
        if (kReadsPrev && ti < 0 && a.prev0 != nullptr) {
          stack = a.prev0;   // one (D, B, width * H) step
          ti = 0;
        } else if (ti < 0 || ti >= dm.T) {
          if (vec) {
            *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
          } else {
            *dst = 0.0f;
          }
          continue;
        }
        const float* src =
            stack +
            (((size_t)ti * dm.D + d) * dm.B + b0 + r) * ((size_t)in.width * H) +
            (size_t)in.v * H + u0 + (vec ? 4 * i : i);
        if (vec) {
          cp_async16(dst, src);
        } else {
          cp_async4(dst, src);
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
  const int j_step = slots % S, tile_step = slots / S;
  const bool store_c = Cell::kHasC && a.cout != nullptr;

  // phase `ph` of a step: the products over `cur` (phase `pr`'s state),
  // the butterflies and the owners' updates into `nxt`, inputs from stage
  // `st`
  const auto run = [&](auto ph, auto pr, const float* cur, float* nxt,
                       const float* W, const float* w_s, int ws, float* st) {
    using Ph = typename decltype(ph)::type;
    constexpr int G = Ph::G, VI = decltype(pr)::type::V, V = Ph::V;
    constexpr int N = G * VI;
    // a lane's weight steps: between its units, and between its weights
    const int wstep = STAGED ? KP * ws : (Ph::kWeightT ? KP : KP * G * H);
    const int gs = STAGED ? 1 : H;
    int j = j_first, rt0 = tile_first * RT;
    for (int round = 0; round < rounds; ++round) {
      const bool live = rt0 < R && j < sb;
      float acc[RT][G] = {};
      if (live && kp < H) {
        const int u = u0 + j;
        const float* wp =
            STAGED ? w_s + kp * ws + j * N
                   : (Ph::kWeightT ? W + (size_t)u * (VI * H) + kp
                                   : W + (size_t)kp * G * H + u);
        lane_dot<G, VI, RT, STAGED>(cur + kp * VI * R + rt0, KP * VI * R, R,
                                    wp, wstep, gs, (H - kp + KP - 1) / KP,
                                    acc);
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
          float y[V] = {};
          if (r < rows) {
            float x[E];
#pragma unroll
            for (int q = 0; q < E; ++q) x[q] = st[((size_t)q * R + r) * S + j];
            float lv[L > 0 ? L : 1] = {};
#pragma unroll
            for (int l = 0; l < L; ++l) lv[l] = loc_s[(l * R + r) * S + j];
            if constexpr (NP == 1 && TakesAct<Cell>::value) {
              Cell::update(act, x, acc[rr], lv[0], y);
            } else if constexpr (NP == 1) {
              Cell::update(x, acc[rr], lv[0], y);
            } else {
              Ph::update(x, acc[rr], lv, y);
            }
#pragma unroll
            for (int l = 0; l < L; ++l) loc_s[(l * R + r) * S + j] = lv[l];
            if constexpr (Cell::kHasC) {
              if (store_c) st[(size_t)r * S + j] = lv[0];   // input 0, read
            }
          }
#pragma unroll
          for (int v = 0; v < V; ++v)
            nxt[((size_t)(u0 + j) * V + v) * R + r] = y[v];
        }
      }
      j += j_step;
      rt0 += tile_step * RT;
      if (j >= S) {
        j -= S;
        rt0 += RT;
      }
    }
  };

  // the exchange of phase `ph`'s new state `nxt` and its store to `out`
  // (where given); after the step's last phase also c's store and the
  // prefetch
  int ps = 0, pf = P - 1;   // ring stages of steps s and s + P - 1
  const auto exchange = [&](auto ph, float* nxt, float* out, bool last,
                            int s, int t, float* st) {
    constexpr int V = decltype(ph)::type::V;
    if (last) cp_async_wait(P - 3);   // step s + 1's inputs, issued P - 2
    __syncthreads();                  // steps ago
    if (C > 1) {
      const int base = u0 * V * R, n = sb * V * R;   // this block's slice
      const int n4 = (base & 3) == 0 ? n / 4 : 0;
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
    const size_t row0 = ((size_t)t * dm.D + d) * dm.B + b0;
    if (out != nullptr) {
      for (int e = tid; e < rows * V * sb; e += kThreads) {
        const int rv = e / sb, jj = e - rv * sb;
        const int r = rv / V, v = rv - r * V;
        out[(row0 + r) * (V * H) + v * H + u0 + jj] =
            nxt[((size_t)(u0 + jj) * V + v) * R + r];
      }
    }
    if (last) {
      if (store_c) {
        for (int e = tid; e < rows * sb; e += kThreads) {
          const int r = e / sb, jj = e - r * sb;
          a.cout[(row0 + r) * H + u0 + jj] = st[(size_t)r * S + jj];
        }
      }
      prefetch(s + P - 1, ring + (size_t)pf * stage);
    }
    if (C > 1) cluster_wait();
  };

  for (int s = 0; s < dm.T; ++s) {
    const int t = Cell::kReverse ? dm.T - 1 - s : s;
    float* st = ring + (size_t)ps * stage;
    if constexpr (NP == 1) {
      float* cur = (s & 1) ? s0 : s1;
      float* nxt = (s & 1) ? s1 : s0;
      run(Tag<P0>{}, Tag<P1>{}, cur, nxt, W0, w0_s, ws0, st);
      exchange(Tag<P0>{}, nxt, a.out, true, s, t, st);
    } else {
      run(Tag<P0>{}, Tag<P1>{}, s1, s0, W0, w0_s, ws0, st);
      exchange(Tag<P0>{}, s0, a.mid, false, s, t, st);
      run(Tag<P1>{}, Tag<P0>{}, s0, s1, W1, w1_s, ws1, st);
      exchange(Tag<P1>{}, s1, a.out, true, s, t, st);
    }
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
cudaError_t launch_cluster(const Args& a, const Plan& p, cudaStream_t st,
                           const Act& act) {
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
  err = cudaLaunchKernelEx(&cfg, cluster_recurrence<Cell, RT, STAGED>, a, p,
                           act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch at the plan's RT and weight placement; RT is R capped at
// kMaxAcc / (G * V).
template <class Cell, int RT>
cudaError_t launch_rt(const Args& a, const Plan& p, cudaStream_t st,
                      const Act& act) {
  if constexpr (RT * max_gv<Cell>() <= kMaxAcc) {
    return p.staged ? launch_cluster<Cell, RT, true>(a, p, st, act)
                    : launch_cluster<Cell, RT, false>(a, p, st, act);
  }
  return cudaErrorInvalidValue;
}

// `act` reaches the update of a cell that declares kAct.
template <class Cell>
cudaError_t launch_planned(const Args& a, const Plan& p, cudaStream_t st,
                           const Act& act = Act{}) {
  if (p.C == 0) return cudaErrorInvalidValue;
  switch (p.RT) {
    case 1: return launch_rt<Cell, 1>(a, p, st, act);
    case 2: return launch_rt<Cell, 2>(a, p, st, act);
    case 4: return launch_rt<Cell, 4>(a, p, st, act);
    case 8: return launch_rt<Cell, 8>(a, p, st, act);
    case 16: return launch_rt<Cell, 16>(a, p, st, act);
  }
  return cudaErrorInvalidValue;
}

inline bool empty(const Dims& dm) {
  return dm.T == 0 || dm.D == 0 || dm.B == 0 || dm.H == 0;
}

}  // namespace
