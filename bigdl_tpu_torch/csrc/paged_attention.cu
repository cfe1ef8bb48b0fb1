// Causal attention over a paged KV pool, fp32 or int8 pools, for Hopper
// (sm_90a).
//
// Replaces bigdl_tpu/ops/pallas_kernels.py `_paged_attn_kernel` and
// `_paged_attention_call` (the Mosaic page walk behind `paged_attention`
// and `paged_spec_verify`), both of its variants.  Contract, as there:
//   q (B, S, H, hd) f32, pos (B, S) i32, kpool/vpool (n_pages, ps, H, hd)
//   f32, ptab (B, P) i32 -> out (B, S, H, hd) f32.  Key position t of row
//   b lives at pool[ptab[b, t / ps], t % ps]; keys with t <= pos[b, s]
//   attend, with scale 1/sqrt(hd).
// The int8 variant (`quantized=True` there) takes int8 pools and f32
// scales kscale/vscale (n_pages, ps, H), one per (page row, head), as
// bigdl_tpu/quant/kv.py writes them, and dequantizes in the loop:
//   score = (q . k_int8) * ks[row] * scale,  acc += (w * vs[row]) . v_int8
// (the JAX kernel multiplies the scales into K and V first; the two
// differ by rounding only).
//
// What bounds it on this card: bytes.  Each live K and V row is read once
// per (row, head) and used for S dot products and S axpys: about S/2
// flops per byte read for fp32 (2S for int8), far below the H100's fp32
// ridge (67 TFLOP/s over 3.35 TB/s, about 20 flops per byte).  So the
// least time is the live K/V bytes (int8: values and scales) over the
// memory rate.
//
// What this design does about it:
//  - one block per (b, h, split): a table of P >= kSplitFromPages pages
//    is cut into `splits` ranges of ceil(P / splits) pages, the count a
//    function of (B, H, P) alone (`split_count`: enough blocks for four an
//    SM, at least kMinSplitPages pages a split), so at decode batch sizes
//    the 132 SMs share a long row's walk instead of B*H blocks walking
//    whole rows.  A walk costs ~3 us a page a layer even with its pages
//    warm in L2 (the chain of barriers below), so in the decode loop the
//    split wins from the 8-page tables up, 1.4x there and 3.5x at 56
//    pages; a shorter table is one walk a row (ContinuousDecoder passes a
//    table as wide as the pages its rows' positions reach);
//  - a block copies its range of the page table into shared memory (no
//    global load waits behind a barrier), walks the range, intersected
//    with the row's live pages, in order and loads each live page ONCE
//    for all S queries (the spec-verify window reuses the page from
//    shared memory), and writes its unnormalised online-softmax state --
//    running max m, denominator l and accumulator acc (S, hd) -- to
//    scratch the wrapper allocates; a split with no live page writes m =
//    -inf and l = 0 and stops;
//  - a second launch merges each (b, s, h)'s splits in split order:
//    m = max m_i, l = sum l_i e^(m_i - m), out = sum acc_i e^(m_i - m) / l,
//    one block a (b, s, h), its weights taken once and its hd values one
//    thread each (the last block of a row merging in place was slower: a
//    serial chain of loads in one block).  No atomics: the same bits every
//    run.  With one split the walk normalises and writes `out` itself, and
//    there is no second launch;
//  - pages wholly beyond the row's largest query position are never read:
//    under the online softmax they contribute exactly zero, so the skip is
//    exact, and a short request on a long reservation costs only its own
//    pages;
//  - pages stream through a ring of up to kMaxStages shared-memory buffers
//    (the deepest that fits, chosen at launch; for a split walk, the
//    deepest that lets two blocks share an SM) with cp.async, neighbouring
//    threads on neighbouring addresses (each page row is hd contiguous
//    values): while one page is scored, the next ones are in flight, so a
//    block keeps several pages of loads outstanding instead of waiting out
//    one memory latency per page.  fp32 rows move 16 bytes a copy (4 when
//    hd % 4 != 0); int8 rows 16 bytes when hd % 16 == 0, 4 when hd % 4 ==
//    0 and one byte at a time by plain loads otherwise (cp.async moves 4,
//    8 or 16 bytes).  An int8 stage also holds the page's ps K and ps V
//    scales of head h (4-byte copies, strided by H in the pool), so an
//    int8 page takes a quarter of an fp32 page's shared memory and the
//    ring's depth is computed for its own stage size.
// What it does not do yet: the scores and the P.V products are fp32 FMAs
// on the CUDA cores, one warp per (query, key row), with three block
// barriers a page; a page costs some microseconds of that serial work
// whatever its bytes.  Splitting shortens each block's chain of pages; it
// does not shorten a page.
//
// A query with pos < 0 (a slot that was never admitted) attends to
// nothing: no page is read and its output is 0 (the gathered-view
// reference gives NaN there; callers discard such rows).  A page id
// outside [0, n_pages) is never read, and its ring stage (stale shared
// memory) is skipped whole: it contributes nothing.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;
constexpr size_t kMaxSmem = 232448;  // 227 KB a block can opt into
// two blocks an SM: half its 228 KB, less the 1 KB each block reserves
constexpr size_t kHalfSm = 233472 / 2 - 1024;
constexpr int kSms = 132;            // SMs of an H100 SXM
constexpr int kSplitFromPages = 8;   // the shortest table that is split
constexpr int kSplitBlocks = 4;      // (b, h, split) blocks an SM, aimed at
constexpr int kMinSplitPages = 4;    // pages a split at least
constexpr int kMergeThreads = 128;   // threads of a merge block
constexpr int kMaxSplits = 8192;     // the merge's weights in 32 KB

// The splits of a call's page walk: enough (b, h, split) blocks for
// kSplitBlocks on every SM (a row's live pages are often fewer than P,
// and a split past them ends at once; an int8 page's stage is a quarter
// of an fp32 one's, so several walks share an SM), at least
// kMinSplitPages pages a split, then as few splits as give that many
// pages each; one split below kSplitFromPages pages, the shortest table
// at which the split was measured to win in the decode loop.  A function
// of (B, H, P).
inline int split_count(int B, int H, int P) {
  if (P < kSplitFromPages) return 1;
  const int rows = B * H > 0 ? B * H : 1;
  int n = (kSplitBlocks * kSms + rows - 1) / rows;
  const int most = (P + kMinSplitPages - 1) / kMinSplitPages;
  if (n > most) n = most;
  if (n < 1) return 1;
  const int pages = (P + n - 1) / n;
  return (P + pages - 1) / pages;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One asynchronous copy of BYTES (16 or 4) from global to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
    static_assert(BYTES == 4, "cp.async here moves 16 or 4 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
  }
}

// VEC consecutive values of T: one cp.async where they make 16 or 4
// bytes, else plain loads (int8 rows whose hd is not a multiple of 4).
template <typename T, int VEC>
__device__ __forceinline__ void copy_values(T* dst, const T* src) {
  constexpr int kBytes = VEC * (int)sizeof(T);
  if constexpr (kBytes == 16 || kBytes == 4) {
    cp_async<kBytes>(dst, src);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = src[i];
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// wait_group takes an immediate: dispatch the ring's runtime depth
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  static_assert(kMaxStages == 4, "one case per pending count");
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// Start copying one page's (ps, hd) K and V tiles of head h into a stage.
template <typename T, int VEC>
__device__ __forceinline__ void issue_page(T* k_dst, T* v_dst,
                                           const T* k_src, const T* v_src,
                                           int ps, int hd,
                                           size_t row_stride) {
  const int per_row = hd / VEC;
  for (int idx = threadIdx.x; idx < ps * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * VEC;
    copy_values<T, VEC>(k_dst + r * hd + c, k_src + r * row_stride + c);
    copy_values<T, VEC>(v_dst + r * hd + c, v_src + r * row_stride + c);
  }
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Bytes of one K (or V) tile of a stage, and of a whole stage: the two
// tiles and, for int8 pools, the page's ps K and ps V scales.
__host__ __device__ inline size_t tile_bytes(int ps, int hd, int elem) {
  return align16((size_t)ps * hd * elem);
}
__host__ __device__ inline size_t stage_bytes(int ps, int hd, int elem) {
  return 2 * tile_bytes(ps, hd, elem) +
         (elem == 1 ? align16(2 * sizeof(float) * (size_t)ps) : 0);
}

// Where a walk leaves its result: `out` (one split), or each (b, s, h,
// split)'s m, l (B, S, H, splits) and acc (B, S, H, splits, hd).
struct Partial {
  float* m;
  float* l;
  float* acc;
  int splits;
};

// Block (b * H + h, split): the walk of one split's page range of row b,
// head h.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const T* __restrict__ kpool,
                       const T* __restrict__ vpool,
                       const float* __restrict__ kscale,
                       const float* __restrict__ vscale,
                       const int* __restrict__ ptab,
                       const int* __restrict__ pos,
                       float* __restrict__ out, Partial part,
                       int S, int H, int hd, int ps, int P, int n_pages,
                       int stages, float scale) {
  constexpr bool kQuant = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tile_b = tile_bytes(ps, hd, (int)sizeof(T));
  const size_t stage_b = stage_bytes(ps, hd, (int)sizeof(T));
  unsigned char* ring = smem;               // stages x (K, V[, ks, vs])
  float* q_s = reinterpret_cast<float*>(ring + stages * stage_b);  // (S, hd)
  float* acc = q_s + S * hd;                // (S, hd) unnormalised P.V
  float* w_s = acc + S * hd;                // (S, ps) scores, then weights
  float* m_s = w_s + S * ps;                // (S) running max
  float* l_s = m_s + S;                     // (S) running denominator
  float* a_s = l_s + S;                     // (S) this page's rescale factor
  int* pos_s = reinterpret_cast<int*>(a_s + S);  // (S) query positions
  int* ptab_s = pos_s + S;                  // this split's page table
  __shared__ int n_live;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int split = blockIdx.y;
  const int per = (P + part.splits - 1) / part.splits;   // pages a split
  const int p0 = split * per;               // the split's first page
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float neg_inf = -__int_as_float(0x7f800000);
  const size_t row_stride = (size_t)H * hd;
  for (int p = tid; p < per && p0 + p < P; p += kThreads)
    ptab_s[p] = ptab[(size_t)b * P + p0 + p];
  for (int s = tid; s < S; s += kThreads) {
    pos_s[s] = pos[b * S + s];
    m_s[s] = neg_inf;
    l_s[s] = 0.f;
  }
  for (int idx = tid; idx < S * hd; idx += kThreads) {
    const int s = idx / hd;
    const int d = idx - s * hd;
    q_s[idx] = q[((size_t)(b * S + s) * H + h) * hd + d];
    acc[idx] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int last = -1;
    for (int s = 0; s < S; ++s) last = max(last, pos_s[s]);
    // the row's live pages past p0, at most `per`
    const int live = last < 0 ? 0 : min(P, last / ps + 1);
    n_live = max(0, min(per, live - p0));
  }
  __syncthreads();
  const int n = n_live;
  if (n == 0 && part.splits > 1) {
    // no live page in this split: m = -inf and l = 0, and the merge never
    // reads the accumulator of such a split
    for (int s = tid; s < S; s += kThreads) {
      const size_t at = ((size_t)(b * S + s) * H + h) * part.splits + split;
      part.m[at] = neg_inf;
      part.l[at] = 0.f;
    }
    return;
  }

  auto issue = [&](int p, int stage) {
    const int phys = ptab_s[p];
    if (phys >= 0 && phys < n_pages) {
      const size_t base = ((size_t)phys * ps * H + h) * hd;
      T* k_dst = reinterpret_cast<T*>(ring + stage * stage_b);
      T* v_dst = reinterpret_cast<T*>(ring + stage * stage_b + tile_b);
      issue_page<T, VEC>(k_dst, v_dst, kpool + base, vpool + base, ps, hd,
                         row_stride);
      if constexpr (kQuant) {
        float* ks_dst =
            reinterpret_cast<float*>(ring + stage * stage_b + 2 * tile_b);
        const size_t sbase = (size_t)phys * ps * H + h;
        for (int r = tid; r < ps; r += kThreads) {
          cp_async<4>(ks_dst + r, kscale + sbase + (size_t)r * H);
          cp_async<4>(ks_dst + ps + r, vscale + sbase + (size_t)r * H);
        }
      }
    }
  };

  // prologue: the first stages-1 pages in flight (one group each, empty
  // groups past the end keep the wait count uniform)
  for (int p = 0; p < stages - 1; ++p) {
    if (p < n) issue(p, p);
    cp_async_commit();
  }
  // page p sits in stage `rd`; page p + stages - 1 goes into stage `wr`
  int rd = 0, wr = stages - 1;
  for (int p = 0; p < n; ++p) {
    if (p + stages - 1 < n) issue(p + stages - 1, wr);
    cp_async_commit();
    cp_async_wait_pending(stages - 1);  // this thread's copies of page p
    __syncthreads();                    // ... and every other thread's
    const T* k_s = reinterpret_cast<const T*>(ring + rd * stage_b);
    const T* v_s = reinterpret_cast<const T*>(ring + rd * stage_b + tile_b);
    const float* ks_s =
        reinterpret_cast<const float*>(ring + rd * stage_b + 2 * tile_b);
    const float* vs_s = ks_s + ps;
    rd = (rd + 1 == stages) ? 0 : rd + 1;
    wr = (wr + 1 == stages) ? 0 : wr + 1;
    // a page id out of range was never issued: its stage holds stale
    // data, so skip the page whole (exact: it would add zero weight).
    // The branch is uniform over the block, and the stage is not read.
    const int phys = ptab_s[p];
    if (phys < 0 || phys >= n_pages) continue;

    // scores: one warp per (query, key row), lanes split hd
    for (int j = warp; j < S * ps; j += kWarps) {
      const int s = j / ps;
      const int r = j - s * ps;
      float dot = 0.f;
      for (int d = lane; d < hd; d += 32)
        dot += q_s[s * hd + d] * static_cast<float>(k_s[r * hd + d]);
      dot = warp_sum(dot);
      if (lane == 0) {
        if constexpr (kQuant) {
          w_s[j] = ((p0 + p) * ps + r <= pos_s[s]) ? dot * ks_s[r] * scale
                                                   : neg_inf;
        } else {
          w_s[j] = ((p0 + p) * ps + r <= pos_s[s]) ? dot * scale : neg_inf;
        }
      }
    }
    __syncthreads();

    // online softmax: running max / denominator, one thread per query;
    // int8 pages fold each row's V scale into its weight after the sum
    for (int s = tid; s < S; s += kThreads) {
      const float m_old = m_s[s];
      float m_new = m_old;
      for (int r = 0; r < ps; ++r) m_new = fmaxf(m_new, w_s[s * ps + r]);
      // still fully masked: keep every weight at exactly zero
      const float m_ref = (m_new == neg_inf) ? 0.f : m_new;
      const float alpha = expf(m_old - m_ref);  // 0 while m_old is -inf
      float sum = 0.f;
      for (int r = 0; r < ps; ++r) {
        const float w = expf(w_s[s * ps + r] - m_ref);
        if constexpr (kQuant) {
          w_s[s * ps + r] = w * vs_s[r];
        } else {
          w_s[s * ps + r] = w;
        }
        sum += w;
      }
      l_s[s] = l_s[s] * alpha + sum;
      m_s[s] = m_new;
      a_s[s] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + w . V; each (s, d) is owned by one thread
    for (int idx = tid; idx < S * hd; idx += kThreads) {
      const int s = idx / hd;
      const int d = idx - s * hd;
      float o = acc[idx] * a_s[s];
      for (int r = 0; r < ps; ++r)
        o = fmaf(w_s[s * ps + r], static_cast<float>(v_s[r * hd + d]), o);
      acc[idx] = o;
    }
    __syncthreads();  // the stage is refilled and the weights rewritten next
  }
  cp_async_wait<0>();

  if (part.splits == 1) {
    for (int idx = tid; idx < S * hd; idx += kThreads) {
      const int s = idx / hd;
      const int d = idx - s * hd;
      const float l = l_s[s];
      out[((size_t)(b * S + s) * H + h) * hd + d] =
          l > 0.f ? acc[idx] / l : 0.f;
    }
    return;
  }
  for (int s = tid; s < S; s += kThreads) {
    const size_t at = ((size_t)(b * S + s) * H + h) * part.splits + split;
    part.m[at] = m_s[s];
    part.l[at] = l_s[s];
  }
  for (int idx = tid; idx < S * hd; idx += kThreads) {
    const int s = idx / hd;
    const int d = idx - s * hd;
    const size_t at = ((size_t)(b * S + s) * H + h) * part.splits + split;
    part.acc[at * hd + d] = acc[idx];
  }
}

// out[(b, s, h), :] from the splits' partials, in split order: a split
// that saw no live key (m = -inf) adds nothing, a row that saw none at
// all comes out 0.  One block a (b, s, h): its first thread takes the
// splits' max, their weights e^(m_i - m) and the denominator once, then
// every thread sums its values of acc with those weights.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(Partial part, float* __restrict__ out, int hd) {
  extern __shared__ float f_s[];            // (splits) weights, -1: none
  __shared__ float den_s;
  const float neg_inf = -__int_as_float(0x7f800000);
  const int n = part.splits;
  const size_t row = blockIdx.x;
  if (threadIdx.x == 0) {
    const float* m = part.m + row * n;
    const float* l = part.l + row * n;
    float mx = neg_inf;
    for (int i = 0; i < n; ++i) mx = fmaxf(mx, m[i]);
    float den = 0.f;
    for (int i = 0; i < n; ++i) {
      float f = -1.f;
      if (mx != neg_inf && m[i] != neg_inf) {
        f = expf(m[i] - mx);
        den = fmaf(l[i], f, den);
      }
      f_s[i] = f;
    }
    den_s = den;
  }
  __syncthreads();
  const float den = den_s;
  const float* acc = part.acc + row * n * hd;
  for (int d = threadIdx.x; d < hd; d += kMergeThreads) {
    float num = 0.f;
    for (int i = 0; i < n; ++i)
      if (f_s[i] >= 0.f) num = fmaf(acc[(size_t)i * hd + d], f_s[i], num);
    out[row * hd + d] = den > 0.f ? num / den : 0.f;
  }
}

// Shared memory of a launch: the ring of `stages` stages of `elem`-byte
// pool values, then the queries, accumulators, weights, softmax state,
// positions and page table.
size_t smem_bytes(int S, int hd, int ps, int P, int stages, int elem) {
  return (size_t)stages * stage_bytes(ps, hd, elem) +
         sizeof(float) * (2 * (size_t)S * hd + (size_t)S * ps +
                          3 * (size_t)S) +
         sizeof(int) * ((size_t)S + P);
}

// The deepest ring (kMaxStages down to 1) whose shared memory fits `cap`
// bytes; 0 when even one stage does not.
int ring_stages(int S, int hd, int ps, int P, int elem,
                size_t cap = kMaxSmem) {
  for (int st = kMaxStages; st >= 1; --st)
    if (smem_bytes(S, hd, ps, P, st, elem) <= cap) return st;
  return 0;
}

template <typename T, int VEC>
cudaError_t launch(const float* q, const T* kpool, const T* vpool,
                   const float* kscale, const float* vscale, const int* ptab,
                   const int* pos, float* out, const Partial& part, int B,
                   int S, int H, int hd, int ps, int P, int n_pages,
                   cudaStream_t stream) {
  const int elem = (int)sizeof(T);
  // a split walks a few pages: a shallower ring that lets two walks share
  // an SM (3 stages of fp32 pages at hd 256, ps 16) beats a deeper one
  int stages = part.splits > 1 ? ring_stages(S, hd, ps, P, elem, kHalfSm) : 0;
  if (stages == 0) stages = ring_stages(S, hd, ps, P, elem);
  if (stages == 0 || part.splits < 1 || part.splits > kMaxSplits)
    return cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0 || hd == 0) return cudaSuccess;
  const size_t smem = smem_bytes(S, hd, ps, P, stages, elem);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.0f / sqrtf((float)hd);
  paged_attention_kernel<T, VEC>
      <<<dim3(B * H, part.splits), kThreads, smem, stream>>>(
          q, kpool, vpool, kscale, vscale, ptab, pos, out, part, S, H, hd,
          ps, P, n_pages, stages, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part.splits == 1) return err;
  merge_kernel<<<(unsigned)(B * S * H), kMergeThreads,
                 sizeof(float) * part.splits, stream>>>(part, out, hd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream` of `device`; returns the cudaError_t of the launch
// (0 on success).  vec = 4 needs hd % 4 == 0 and 16-byte aligned pools.
// The walk is cut into `splits` page ranges (the wrapper passes
// `split_count`'s); with more than one, m and l (B, S, H, splits) and acc
// (B, S, H, splits, hd) are scratch, and a second launch merges them.
int bigdl_paged_attention_f32(const float* q, const float* kpool,
                              const float* vpool, const int* ptab,
                              const int* pos, float* out, float* m, float* l,
                              float* acc, int B, int S, int H, int hd, int ps,
                              int P, int n_pages, int splits, int vec,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Partial part{m, l, acc, splits};
  if (vec == 4)
    return (int)launch<float, 4>(q, kpool, vpool, nullptr, nullptr, ptab, pos,
                                 out, part, B, S, H, hd, ps, P, n_pages, st);
  return (int)launch<float, 1>(q, kpool, vpool, nullptr, nullptr, ptab, pos,
                               out, part, B, S, H, hd, ps, P, n_pages, st);
}

// The int8 variant: kpool/vpool int8 (n_pages, ps, H, hd), kscale/vscale
// f32 (n_pages, ps, H).  vec = 16 needs hd % 16 == 0 and 16-byte aligned
// pools, vec = 4 hd % 4 == 0 and 4-byte aligned pools; vec = 1 takes
// any hd.
int bigdl_paged_attention_int8(const float* q, const int8_t* kpool,
                               const int8_t* vpool, const float* kscale,
                               const float* vscale, const int* ptab,
                               const int* pos, float* out, float* m, float* l,
                               float* acc, int B, int S, int H, int hd,
                               int ps, int P, int n_pages, int splits,
                               int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Partial part{m, l, acc, splits};
  if (vec == 16)
    return (int)launch<int8_t, 16>(q, kpool, vpool, kscale, vscale, ptab, pos,
                                   out, part, B, S, H, hd, ps, P, n_pages,
                                   st);
  if (vec == 4)
    return (int)launch<int8_t, 4>(q, kpool, vpool, kscale, vscale, ptab, pos,
                                  out, part, B, S, H, hd, ps, P, n_pages, st);
  return (int)launch<int8_t, 1>(q, kpool, vpool, kscale, vscale, ptab, pos,
                                out, part, B, S, H, hd, ps, P, n_pages, st);
}

// The split count of a call at (B, H, P).
int bigdl_paged_attention_splits(int B, int H, int P) {
  return split_count(B, H, P);
}

// Depth of the ring a launch at this shape uses for pools of `elem`-byte
// values (4: fp32, 1: int8); 0 when even one stage needs more than
// 227 KB of shared memory (the shape cannot launch).
int bigdl_paged_attention_stages(int S, int hd, int ps, int P, int elem) {
  return ring_stages(S, hd, ps, P, elem);
}

const char* bigdl_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
