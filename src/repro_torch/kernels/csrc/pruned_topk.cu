// Fused block-pruned exact cosine top-k for Hopper (sm_90a), fp32 SIMT,
// over an fp32 or a bf16 db.
//
// Replaces the TPU kernel src/repro/kernels/cosine_topk.py:pruned_topk
// (body _make_kernel, pallas_call at cosine_topk.py:310).  It computes
// what that kernel computes: per (query tile, db tile) in block_order
// visit order, the Eq. 13 interval bound (min over pivots, optionally
// min'd with ub_cap; over the box of the query's interval [a_lo, a_hi],
// the float32 neighbours of qp, and the tile's [lo, hi]: eq13.cuh), a skip
// test against every row's running k-th best
// τ, and for tiles that survive the fp32 scores q @ dbᵀ merged into a
// running top-k.  computed and elem are indexed by db tile id.
//
// What bounds it on the H100.  A computed tile is 2·bm·bn·D fp32 flops
// against bn·D·4 bytes of db rows (64 flops per byte at bm = 128): the
// fp32 SIMT rate (67 TFLOP/s, 128 FMAs per SM per cycle) bounds it, not
// HBM.  What keeps the FMA pipes fed:
//
// - Splits.  The grid is (query tiles, splits).  Split s of query tile i
//   visits the steps j ≡ s (mod S) of block_order[i, :], in order, with
//   its own running top-k and τ seeded from tau_init, so `computed` stays
//   deterministic; S = 1 is the reference's single pass.  S fills whole
//   waves of resident CTAs on the 132 SMs (choose_splits in
//   cosine_topk.py).  Each split keeps its partial top-k list in [S, M, k]
//   scratch.  A split's τ never exceeds the single pass's τ at the same
//   step, so splits compute a superset of the single pass's tiles.
// - The merge is the epilogue.  A CTA whose visits have ended publishes
//   its list (a GPU-scope fence, one arrival on its query tile's counter);
//   the last of the tile's S CTAs to arrive reads the S lists from L2 and
//   merges them, one warp per row, in split order: score descending, then
//   split, then slot, as merge_splits_plain.  Each row goes straight to
//   output row row_out[row], the caller's order.  S = 1 is the same code
//   (the one CTA is the last; its list is copied out).  No launch of its
//   own, and no gather or argsort after the kernel to undo a query sort.
// - k-major panels.  The wrapper hands the kernel the query tiles and the
//   db tiles transposed into panels of 128 rows, [panel][D][128] (one copy
//   of the db per call, timed with the kernel).  A K-step of 34
//   columns of a panel is then one contiguous 17 KB block, which one
//   thread copies with a bulk copy (the TMA unit's 1-D form) completing on
//   an mbarrier: no thread spends registers or issue slots on addresses.
//   Per column a thread reads its 8 query and 8 db values as 4 LDS.128
//   (conflict-free: the db row as 16 consecutive float4, the query row as
//   2 broadcast ones) for 64 FMAs, and the next column's fragments load
//   while this one's FMAs issue: 64 accumulators + 2 x 16 fragment
//   registers fit the 128 registers that two CTAs per SM allow.  Each
//   score sums its D products in column order with fmaf, a fixed order;
//   D needs no padding.
// - Shared memory per CTA (p pivots):
//     Q tile, resident    D·128 floats     (51,200 B at D = 100)
//     db ring             2 stages of 34·128 floats + a step's intervals
//                         (a bf16 db chunk fills the first half of its
//                         slot; the layout, and so the epilogue's merge
//                         room and the occupancy, stay the fp32 one's)
//     Q ring (streamed)   34·128 floats per stage, where Q is not resident
//     qp                  128·p floats     (8,192 B at p = 16)
//     τ per row, merge candidates (128 per half-warp), barriers  16,960 B
//   The Q tile stays resident for the CTA's life when the total fits in
//   113 KB, so two CTAs (16 warps) share an SM: 112,192 B at D = 100,
//   p = 16.  Above that (D = 256 needs 128 KB for Q alone) Q chunks ride
//   in the ring beside the db chunks.  One block barrier per K-step: a
//   stage is refilled only after every warp has passed the next step's
//   barrier.  Two stages of 34 columns measured faster than three of 20
//   (fewer barriers at the same prefetch distance in time).
// - The copies of the next visit step's tile, with that tile's pivot
//   intervals, are issued speculatively while this tile is scored and
//   merged; the skip decision for it still waits for this tile's τ, and
//   reads the intervals from the ring.  A skip drains the ring and
//   restarts it at the next tile that is needed; in a run of skips each
//   step's intervals are prefetched into L1 one step ahead.
// - Merge without staging the score tile: the 16 threads of a half-warp
//   hold 8 query rows' 128 scores each.  Each score is compared with its
//   row's k-th value (τ, per row in shared memory); one vote per row skips
//   rows where nothing enters.  Entering scores are compacted into the
//   half-warp's list and placed by rank into the running top-k, which
//   lives in global scratch (L2) so any k <= bn fits.  The order is the
//   reference's: an existing slot beats an equal new score, a lower column
//   beats a higher one.
// - What is left: the per-step skip decision (128 rows x p pivots of
//   Eq. 13 over the box, one corner and one root each, then a block vote;
//   each pivot also derives the query's interval from qp, which stays one
//   float per (row, pivot) in shared memory: two would cost 8 KB and the
//   resident Q tile at D = 100) and the block
//   barriers around it and around the merge keep the FMA pipes idle for a
//   large share of each tile (PERF.md).
//
// A bf16 db (the reference's dot_general of fp32 queries with bf16 rows,
// preferred_element_type f32): the wrapper hands the kernel bf16 panels,
// each K-step's bulk copy moves half the bytes (34 x 128 x 2 = 8,704 B),
// and fma_panel widens a thread's 8 db values to fp32 (exact) before the
// same 64 fmaf in the same column order.  A score is then the fp32 dot
// product with the bf16-rounded row; the Q tile, τ, the intervals and the
// merge stay fp32.  The kernel is templated on the db element type.
//
// Why fp32 SIMT and not wgmma: the reference guards fp32 scores with
// margin = 4e-7 and seeds τ 1e-6 below the prescan value; TF32 keeps
// about 3 digits, and 3xTF32 on wgmma reaches about fp32 accuracy but not
// fp32 rounding, for a ceiling only ~2.5x higher.  No --use_fast_math.
// Bounds come from eq13.cuh, rounded op by op so they equal the plain
// PyTorch version bit for bit; its header says why they are sound near
// |a| = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "eq13.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileM = 128;          // max query rows per CTA
constexpr int kTileN = 128;          // db rows per score sub-tile
constexpr int kStep = 34;            // columns (k-major rows) per stage
constexpr int kStages = 2;
constexpr int kStageFloats = kStep * kTileN;
constexpr int kMaxPivots = 64;
constexpr int kCand = kTileN;        // merge candidates per half-warp
constexpr int kLhFloats = 2 * kMaxPivots;  // a step's interval row, per stage
constexpr size_t kTwoCtaBytes = 113 * 1024;
// The epilogue merges in the Q tile and the copy ring, free after the last
// tile: (score, id) pairs, at least 3k per merging warp (the running list,
// its next version and one staged list); the resident-Q ring alone holds
// kRingEntries.
constexpr int kRingEntries = kStages * (kStageFloats + kLhFloats) / 2;
constexpr int kMaxK = 1024;
static_assert(3 * kMaxK <= kRingEntries, "one warp merges k = kMaxK in the ring");

struct Params {
  const float* qt;              // [mt, d, 128] query tiles, k-major
  const void* dbt;              // [nt * nsub, d, 128] db sub-tiles, k-major
                                // (float or __nv_bfloat16: the kernel's T)
  const float* qp;              // [m, p]
  const float* lh;              // [nt, 2 * pp]: lo, then hi, each padded
  const float* tau;             // [m] seeds (already lowered), -inf if none
  const int* block_order;       // [mt, nt]
  const uint8_t* row_valid;     // [n]
  const float* ub_cap;          // [m, nt] or null
  const float* dp;              // [n, p] or null (element stats)
  float* top_s;                 // [splits, m, k] running top-k per split
  int* top_i;                   // [splits, m, k]
  float* out_s;                 // [m, k] merged result (fused kernel)
  int* out_i;                   // [m, k]
  const int* row_out;           // [m] output row of each row, or null
  unsigned* arrive;             // [3, mt] zeros: split CTAs done, then
                                // the epilogue's clock (see epilogue)
  int* computed;                // [mt, nt]
  int* elem;                    // [mt, nt] or null
  int m, m_valid, d, p, k, bm, bn, nt;
  float margin;
  int prune, resident;
};

constexpr int kBarBytes = 32;        // kStages + 1 mbarriers, 16-byte aligned

size_t smem_floats(int d, int p, bool resident) {
  return kBarBytes / sizeof(float) + (resident ? (size_t)d * kTileM : 0) +
         (size_t)kStages * (kStageFloats * (resident ? 1 : 2) + kLhFloats) +
         (size_t)kTileM * p + kTileM + (size_t)kWarps * 2 * 2 * kCand +
         kWarps;
}

bool q_resident(int d, int p) {
  return smem_floats(d, p, true) * sizeof(float) <= kTwoCtaBytes;
}

// A load the compiler may not move: issued here, waited for at first use.
__device__ __forceinline__ int ld_pinned(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// One thread: expect `bytes` on `bar` and copy them, contiguous, from
// global to shared memory (the bulk-copy form of the TMA unit).
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four consecutive bf16 values widened to fp32 (exact: a bf16 is the top
// half of an fp32), from one 8-byte load.
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

// acc[i][j] += sum over `cols` k-major rows of a[row i] · b[col j], for
// the thread's rows 4ty + {0..3}, 64 + 4ty + {0..3} and columns 4tx +
// {0..3}, 64 + 4tx + {0..3}.  The next row's fragments load while this
// row's 64 FMAs issue; the load past the last row reads shared memory that
// follows every panel and is discarded.  b holds the db panel as T (float
// or bf16, widened on load); a is the fp32 Q panel.
template <typename T>
__device__ __forceinline__ void fma_panel(float (&acc)[8][8], const float* a,
                                          const T* b, int cols, int tx,
                                          int ty) {
  const float* pa = a + 4 * ty;
  const T* pb = b + 4 * tx;
  float4 a0 = lds4(pa), a1 = lds4(pa + 64), b0 = lds4(pb), b1 = lds4(pb + 64);
#pragma unroll 2
  for (int kk = 0; kk < cols; ++kk) {
    pa += kTileM;
    pb += kTileN;
    const float4 na0 = lds4(pa), na1 = lds4(pa + 64);
    const float4 nb0 = lds4(pb), nb1 = lds4(pb + 64);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    a0 = na0;
    a1 = na1;
    b0 = nb0;
    b1 = nb1;
  }
}

// Merge one row's n (1..128) entering scores cv/ci into its running top-k
// ts/ti (descending, in global memory).  Called by the 16 lanes of a
// half-warp (hmask); hl is the lane within the half.  The result is the
// first k of a stable descending sort of concat(existing, new scores in
// column order): an existing slot beats an equal new score, a lower column
// beats a higher one.  The list is read 16 slots at a time, lane hl
// holding slot cb + hl, so a row of k <= 16 costs one load; each entering
// score's rank among the slots is a vote of the half-warp.  The new k-th
// value goes to *thr.
__device__ __forceinline__ void merge_row(float* ts, int* ti, int k,
                                          const float* cv, const int* ci,
                                          int n, int hl, unsigned hmask,
                                          float* thr) {
  constexpr int kPer = kCand / 16;
  const float v0 = hl < k ? ts[hl] : 0.f;
  const int id0 = hl < k ? ti[hl] : -1;
  int pos[kPer];
  // rank among the entering scores: score descending, then column
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const int e = hl + 16 * t;
    pos[t] = k;
    if (e < n) {
      const float w = cv[e];
      const int id = ci[e];
      int a = 0;
      for (int f = 0; f < n; ++f) {
        const float x = cv[f];
        a += (x > w) || (x == w && ci[f] < id);
      }
      pos[t] = a;
    }
  }
  // plus the existing slots >= the score
  for (int cb = 0; cb < k; cb += 16) {
    const int sl = cb + hl;
    const float v = cb == 0 ? v0 : (sl < k ? ts[sl] : 0.f);
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      if (16 * t >= n) break;
      for (int e16 = 0; e16 < 16 && 16 * t + e16 < n; ++e16) {
        const unsigned ge =
            __ballot_sync(hmask, sl < k && v >= cv[16 * t + e16]);
        if (hl == e16) pos[t] += __popc(ge);
      }
    }
  }
  int first = k;  // the best entering score's slot: no slot above it moves
#pragma unroll
  for (int t = 0; t < kPer; ++t) first = min(first, pos[t]);
  for (int off = 8; off > 0; off >>= 1)
    first = min(first, __shfl_xor_sync(hmask, first, off));
  // existing slots move down by the entering scores strictly above them;
  // the bottom 16 slots first, so a write lands only on slots already read
  for (int cb = (k - 1) & ~15; cb >= (first & ~15); cb -= 16) {
    const int sl = cb + hl;
    float v = 0.f;
    int id = -1, to = k;
    if (sl < k && sl >= first) {
      v = cb == 0 ? v0 : ts[sl];
      id = cb == 0 ? id0 : ti[sl];
      to = sl;
      for (int f = 0; f < n; ++f) to += cv[f] > v;
    }
    __syncwarp(hmask);
    if (to < k) {
      ts[to] = v;
      ti[to] = id;
      if (to == k - 1) *thr = v;
    }
    __syncwarp(hmask);
  }
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    if (pos[t] < k) {
      const int e = hl + 16 * t;
      ts[pos[t]] = cv[e];
      ti[pos[t]] = ci[e];
      if (pos[t] == k - 1) *thr = cv[e];
    }
  }
  __syncwarp(hmask);
}

__device__ __forceinline__ unsigned long long globaltimer_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Publish this CTA's list and return, in every thread, whether it is the
// last of its query tile's `splits` CTAs to finish (the threadFenceReduction
// pattern: each thread's stores, a GPU-scope fence, a block barrier, one
// arrival on the tile's counter; the last arrival fences again before any
// thread of its CTA reads the other lists).
__device__ __forceinline__ bool last_to_arrive(unsigned* count, int splits,
                                               int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(count, 1u) == (unsigned)splits - 1;
    if (last) __threadfence();
    *flag = last;
  }
  __syncthreads();
  return *flag;
}

// One warp: the first k of running list r (k entries, descending) merged
// with list l (descending, from a later split), written to o; an entry of
// r stays ahead of an equal score of l.  Only the c entries of l above
// r's k-th score can enter.  Lane t writes output slots [t n, t n + n),
// n = ceil(k / 32): a binary search finds how many of the slots before
// them come from r (the co-rank), then it walks both lists.  Returns
// false, writing nothing, when no entry of l enters.
__device__ __forceinline__ bool merge_into(const float* rs, const int* ri,
                                           const float* ls, const int* li,
                                           float* os, int* oi, int k,
                                           int lane) {
  const float kth = rs[k - 1];
  int c = 0;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const unsigned in = __ballot_sync(0xffffffffu, j0 + lane < k && ls[j0 + lane] > kth);
    c += __popc(in);
    if (in != 0xffffffffu) break;
  }
  if (c == 0) return false;
  const int n = (k + 31) / 32, d0 = min(lane * n, k), d1 = min(d0 + n, k);
  int lo = max(0, d0 - c), hi = d0;
  while (lo < hi) {                       // r[i] ahead of l[j - 1]: more of r
    const int i = (lo + hi) >> 1, j = d0 - i;
    if (j > 0 && rs[i] >= ls[j - 1]) lo = i + 1; else hi = i;
  }
  for (int d = d0, i = lo, j = d0 - lo; d < d1; ++d) {
    const bool take_r = j >= c || rs[i] >= ls[j];
    os[d] = take_r ? rs[i] : ls[j];
    oi[d] = take_r ? ri[i] : li[j];
    i += take_r;
    j += !take_r;
  }
  __syncwarp();
  return true;
}

// One warp: lists s0 .. s0 + g - 1 (k entries each) of the nq rows row,
// row + dr, ..., row + (nq - 1) dr, from the [splits, m, k] scratch, with
// L2-only loads (L1 is not coherent across SMs); row q's lists land one
// after another at fs + q * stride.  Every lane has up to kStageLoads
// loads in flight before its first store.
constexpr int kStageLoads = 16;

__device__ __forceinline__ void stage_lists(float* fs, int* fi, int stride,
                                            const float* ps, const int* pi,
                                            size_t m, size_t row, int dr,
                                            int nq, int s0, int g, int k,
                                            int lane) {
  const int per_row = g * k, n = nq * per_row;
  for (int e0 = lane; e0 < n; e0 += 32 * kStageLoads) {
    float v[kStageLoads];
    int id[kStageLoads], to[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int e = e0 + 32 * u, q = e / per_row, x = e - q * per_row, t = x / k;
      const size_t at = ((size_t)(s0 + t) * m + row + (size_t)q * dr) * k + (x - t * k);
      to[u] = q * stride + x;
      if (e < n) {
        v[u] = __ldcg(ps + at);
        id[u] = __ldcg(pi + at);
      }
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      if (e0 + 32 * u < n) {
        fs[to[u]] = v[u];
        fi[to[u]] = id[u];
      }
    }
  }
}

// In the last CTA of query tile i: merge the tile's `splits` lists in
// split order, one warp per row, in `entries` free (score, id) pairs of
// shared memory at `buf`.  A warp stages as many whole rows as its share
// holds with one batch of loads and merges each list by list behind two
// running lists (merge_into); a row larger than the share is staged g
// lists at a time.
__device__ __forceinline__ void merge_tile(const Params& prm, float* buf,
                                           int entries, int row0, int rows,
                                           int splits) {
  const int k = prm.k, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t m = prm.m;
  const float* ps = prm.top_s;
  const int* pi = prm.top_i;
  const int* row_out = prm.row_out;
  float* out_s = prm.out_s;
  int* out_i = prm.out_i;
  // the main loop's db stream has pushed the lists out of L2: every
  // thread asks for a share of the tile's 128-byte lines at once, before a
  // warp waits on one
  const size_t lines = ((size_t)rows * k * sizeof(float) + 127) / 128;
  for (size_t x = threadIdx.x; x < splits * lines; x += kThreads) {
    const size_t at = ((x / lines) * m + row0) * k;
    const size_t off = (x % lines) * 128;
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
        reinterpret_cast<const char*>(ps + at) + off));
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
        reinterpret_cast<const char*>(pi + at) + off));
  }
  const int nw = max(1, min(min(kWarps, rows), entries / (3 * k)));
  if (warp >= nw) return;
  const int per = entries / nw;           // pairs per warp
  float* fs = buf + (size_t)warp * 2 * per;
  int* fi = reinterpret_cast<int*>(fs + per);
  auto write_row = [&](const float* rs, const int* ri, size_t row) {
    const size_t orow = row_out != nullptr ? (size_t)__ldg(row_out + row) : row;
    for (int j = lane; j < k; j += 32) {
      out_s[orow * k + j] = rs[j];
      out_i[orow * k + j] = ri[j];
    }
  };
  // merge the n lists at l0, l0 + k, ... of a row's staging (rs, ri) into
  // its running list at *cur, the other running buffer at *nxt
  auto merge_lists = [&](float* rs, int* ri, int l0, int n, int* cur, int* nxt) {
    for (int t = 0; t < n; ++t) {
      const int l = l0 + t * k;
      if (merge_into(rs + *cur, ri + *cur, rs + l, ri + l, rs + *nxt, ri + *nxt, k,
                     lane)) {
        const int x = *cur;
        *cur = *nxt;
        *nxt = x;
      }
    }
  };
  // [B: k][A: k][staged lists]: the first load puts list 0 at A
  const int whole = (splits + 1) * k;
  if (whole <= per) {
    const int q = per / whole;            // rows staged at once
    for (int r0 = warp; r0 < rows; r0 += nw * q) {
      const int nq = min(q, (rows - r0 + nw - 1) / nw);
      stage_lists(fs + k, fi + k, whole, ps, pi, m, row0 + r0, nw, nq, 0, splits, k,
                  lane);
      __syncwarp();
      for (int x = 0; x < nq; ++x) {
        float* rs = fs + x * whole;
        int* ri = fi + x * whole;
        int cur = k, nxt = 0;
        merge_lists(rs, ri, 2 * k, splits - 1, &cur, &nxt);
        write_row(rs + cur, ri + cur, (size_t)row0 + r0 + x * nw);
      }
      __syncwarp();
    }
    return;
  }
  const int g_max = (per - 2 * k) / k;    // staged lists per load, >= 1
  for (int r = warp; r < rows; r += nw) {
    const size_t row = (size_t)row0 + r;
    int cur = k, nxt = 0;
    for (int s = 0; s < splits;) {
      const int base = s == 0 ? k : 2 * k;
      const int g = min(splits - s, s == 0 ? g_max + 1 : g_max);
      stage_lists(fs + base, fi + base, 0, ps, pi, m, row, 0, 1, s, g, k, lane);
      __syncwarp();
      merge_lists(fs, fi, 2 * k, s == 0 ? g - 1 : g, &cur, &nxt);
      s += g;
    }
    write_row(fs + cur, fi + cur, row);
    __syncwarp();
  }
}

// The fused kernel's epilogue, after the CTA's last copy has landed.  Out
// of line, and taking nothing from the main loop but prm (every other
// value it needs comes from blockIdx, gridDim and the shared-memory
// layout), so the main loop's registers are allocated as in the kernel
// without it: inlined, it moved that loop's spills and cost 3-4 % at one
// split (PERF.md).  It merges in the Q tile and the copy ring, which
// follow each other and are both free now.  The tile's counters are spent
// once the last CTA has arrived: arrive[i] keeps the merge's time in ns,
// arrive[mt + i] and arrive[2 mt + i] the low 32 bits of %globaltimer at
// the last arrival and at the merge's end, so a caller can tell what the
// merge adds to the kernel's end.
__device__ __noinline__ void epilogue(const Params& prm) {
  extern __shared__ __align__(16) float smem[];
  const bool resident = prm.resident;
  const int stage = kStageFloats * (resident ? 1 : 2) + kLhFloats;
  float* buf = smem + kBarBytes / sizeof(float);
  const int floats = (resident ? prm.d * kTileM : 0) + kStages * stage;
  int* red = reinterpret_cast<int*>(buf + floats + kTileM * prm.p + kTileM +
                                    kWarps * 2 * 2 * kCand);
  const int i = blockIdx.x, mt = gridDim.x, splits = gridDim.y, row0 = i * prm.bm;
  if (!last_to_arrive(prm.arrive + i, splits, red)) return;
  const unsigned long long t0 = globaltimer_ns();
  merge_tile(prm, buf, floats / 2, row0, min(prm.bm, prm.m - row0), splits);
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long t1 = globaltimer_ns();
    prm.arrive[i] = (unsigned)(t1 - t0);
    prm.arrive[mt + i] = (unsigned)t0;
    prm.arrive[2 * mt + i] = (unsigned)t1;
  }
}

// kFused: the epilogue merges the splits into out_s/out_i; without it the
// partial lists in top_s/top_i are the result (merge_splits_kernel's
// input, kept as the route the epilogue is compared with).  T: the db's
// element type, float or __nv_bfloat16.
template <bool kFused, typename T>
__global__ void __launch_bounds__(kThreads, 2)
pruned_topk_kernel(const __grid_constant__ Params prm) {
  extern __shared__ __align__(16) float smem[];
  static_assert(kStages + 1 <= kBarBytes / 8, "one mbarrier per stage + Q");
  const int p = prm.p, k = prm.k, bm = prm.bm, bn = prm.bn, nt = prm.nt;
  const int d = prm.d;
  const bool resident = prm.resident;
  // a stage: db chunk [kStep][128], Q chunk when streamed, and the
  // interval row of the step whose first chunk it holds
  const int stage = kStageFloats * (resident ? 1 : 2) + kLhFloats;
  const int pp = (p + 3) / 4 * 4;
  // mbarriers: one per ring stage, then the resident Q tile's
  const unsigned bars = smem_addr(smem), qbar = bars + 8 * kStages;
  float* qres = smem + kBarBytes / sizeof(float);       // [d][kTileM]
  float* ring = qres + (resident ? d * kTileM : 0);     // [kStages][stage]
  float* qp_s = ring + kStages * stage;                 // [kTileM][p]
  float* thr_s = qp_s + kTileM * p;                     // [kTileM] τ per row
  float* cand = thr_s + kTileM;                         // per half-warp
  int* red = reinterpret_cast<int*>(cand + kWarps * 2 * 2 * kCand);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4, half = lane >> 4;
  const unsigned hmask = 0xffffu << (16 * half);
  const int i = blockIdx.x, s = blockIdx.y, splits = gridDim.y;
  const int row0 = i * bm;
  const int rows = min(bm, prm.m - row0);
  float* ts = prm.top_s + ((size_t)s * prm.m + row0) * k;
  int* ti = prm.top_i + ((size_t)s * prm.m + row0) * k;
  float* cv = cand + (warp * 2 + half) * 2 * kCand;
  int* ci = reinterpret_cast<int*>(cv + kCand);
  const int* order = prm.block_order + (size_t)i * nt;
  const float* qtile = prm.qt + (size_t)i * d * kTileM;

  for (int e = tid; e < rows * k; e += kThreads) {
    ts[e] = prm.tau[row0 + e / k];
    ti[e] = -1;
  }
  for (int r = tid; r < kTileM; r += kThreads)
    thr_s[r] = r < rows ? prm.tau[row0 + r] : -INFINITY;
  for (int e = tid; e < kTileM * p; e += kThreads) {
    const int r = e / p;
    qp_s[e] = r < rows ? prm.qp[(size_t)(row0 + r) * p + e % p] : 1.f;
  }
  if (tid == 0) {
    for (int b = 0; b <= kStages; ++b) mbar_init(bars + 8 * b);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (resident && tid == 0) {
    mbar_expect(qbar, (unsigned)d * kTileM * 4);
    bulk_copy(qres, qtile, (unsigned)d * kTileM * 4, qbar);
  }

  const int nsteps = (nt - s + splits - 1) / splits;
  const int nsub = (bn + kTileN - 1) / kTileN;
  const int nchunk = (d + kStep - 1) / kStep;

  // the copy ring's producer cursor and chunk counters (see issue below)
  int pt = 0, psub = 0, pc = 0, pjb = 0, issued = 0, consumed = 0;

  // Skip decisions from step t0 on, with every row's current τ: writes
  // computed (and elem) for each step visited; returns the first step
  // whose tile is needed, or nsteps.  With `in_ring`, step t0 (tile
  // jb0) is the one whose first chunk the ring holds next, and its
  // interval row is read from that stage; later steps read theirs from
  // global memory, prefetched into L1 one step ahead.
  auto decide_from = [&](int t0, bool in_ring, int jb0) -> int {
    int jb = t0 < nsteps && !in_ring ? ld_pinned(order + s + splits * t0) : jb0;
    for (int t = t0; t < nsteps; ++t) {
      const int jbn = t + 1 < nsteps ? ld_pinned(order + s + splits * (t + 1)) : 0;
      const float* lh_j = prm.lh + (size_t)jb * 2 * pp;
      if (in_ring && t == t0) {
        const int slot = consumed % kStages;
        mbar_wait(bars + 8 * slot, (consumed / kStages) & 1);
        lh_j = ring + slot * stage + stage - kLhFloats;
      }
      // two threads per row, each taking every other pivot; the interval
      // ends of 16 pivots load at once (min over pivots is order-free).
      // Each pivot: the query's interval from qp, then the box's corner
      // (no inverted-interval case, as in the reference's skip test)
      const int r = tid >> 1, h = tid & 1;
      const float cap = prm.ub_cap != nullptr && r < rows
          ? prm.ub_cap[(size_t)(row0 + r) * nt + jb] : 0.f;
      float ub = INFINITY;
      for (int q0 = 0; q0 < p; q0 += 16) {
        float lv[8], hv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int q = q0 + h + 2 * u;
          lv[u] = q < p ? lh_j[q] : 0.f;
          hv[u] = q < p ? lh_j[pp + q] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int q = q0 + h + 2 * u;
          if (q < p) {
            const float a = qp_s[r * p + q];
            ub = nan_min(ub, box_ub<false>(query_lo(a), query_hi(a), lv[u],
                                           hv[u], radicand(lv[u]),
                                           radicand(hv[u])));
          }
        }
      }
      if (t + 1 < nsteps && tid * 32 < 2 * pp)
        asm volatile("prefetch.global.L1 [%0];\n"
                     ::"l"(prm.lh + (size_t)jbn * 2 * pp + tid * 32));
      ub = nan_min(ub, __shfl_xor_sync(0xffffffffu, ub, 1));
      if (prm.ub_cap != nullptr) ub = nan_min(ub, cap);
      const bool pred = h == 0 && row0 + r < prm.m_valid &&
                        __fadd_rn(ub, prm.margin) >= thr_s[r];
      const int needed = __syncthreads_or(pred) || !prm.prune;
      if (tid == 0) prm.computed[(size_t)i * nt + jb] = needed;

      // per-(query, row) Eq. 13 bound against τ, skipped tile or not: the
      // box of the query's interval and the row's point dp
      if (prm.elem != nullptr) {
        int cnt = 0;
        for (int e = tid; e < bm * bn; e += kThreads) {
          const int er = e / bn, c = e % bn;
          const size_t row = (size_t)jb * bn + c;
          if (row0 + er >= prm.m_valid || !prm.row_valid[row]) continue;
          float eub = 0.f;
          for (int q = 0; q < p; ++q) {
            const float a = qp_s[er * p + q], s = prm.dp[row * p + q];
            const float rs = radicand(s);
            const float cand_ub =
                box_ub<false>(query_lo(a), query_hi(a), s, s, rs, rs);
            eub = q == 0 ? cand_ub : nan_min(eub, cand_ub);
          }
          cnt += __fadd_rn(eub, prm.margin) < thr_s[er];
        }
        for (int off = 16; off > 0; off >>= 1)
          cnt += __shfl_down_sync(0xffffffffu, cnt, off);
        if (lane == 0) red[warp] = cnt;
        __syncthreads();
        if (tid == 0) {
          int total = 0;
          for (int w = 0; w < kWarps; ++w) total += red[w];
          prm.elem[(size_t)i * nt + jb] = total;
        }
      }
      if (needed) return t;
      jb = jbn;
    }
    return nsteps;
  };

  // The copy ring: a stream of (step, sub-tile, K-step) chunks, each one
  // contiguous bulk copy issued by thread 0, that runs kStages - 1 chunks
  // ahead of the scores and assumes every later step is needed; a skip
  // drains it and restarts it.  Chunk y lands in stage y % kStages and
  // completes phase (y / kStages) & 1 of that stage's mbarrier; every
  // chunk issued is waited for exactly once.
  auto restart = [&](int t0) {
    pt = t0;
    psub = pc = 0;
    if (tid == 0 && pt < nsteps) pjb = ld_pinned(order + s + splits * pt);
  };
  auto issue = [&]() {
    if (pt >= nsteps) return;
    if (tid == 0) {
      const int slot = issued % kStages;
      float* st = ring + slot * stage;
      const int k0 = pc * kStep;
      const unsigned cols = (unsigned)min(kStep, d - k0);
      const unsigned bytes = cols * kTileN * (unsigned)sizeof(T);
      const unsigned q_bytes = resident ? 0u : cols * kTileM * 4;
      const bool first = pc == 0 && psub == 0;
      const unsigned lh_bytes = first ? 2u * pp * 4 : 0u;
      mbar_expect(bars + 8 * slot, bytes + q_bytes + lh_bytes);
      bulk_copy(st, static_cast<const T*>(prm.dbt) +
                        (((size_t)pjb * nsub + psub) * d + k0) * kTileN,
                bytes, bars + 8 * slot);
      if (!resident)
        bulk_copy(st + kStageFloats, qtile + (size_t)k0 * kTileM, q_bytes,
                  bars + 8 * slot);
      if (first)
        bulk_copy(st + stage - kLhFloats, prm.lh + (size_t)pjb * 2 * pp,
                  lh_bytes, bars + 8 * slot);
    }
    ++issued;
    if (++pc == nchunk) {
      pc = 0;
      if (++psub == nsub) {
        psub = 0;
        ++pt;
        // the next tile's id loads now, one chunk before its first copy
        if (tid == 0 && pt < nsteps) pjb = ld_pinned(order + s + splits * pt);
      }
    }
  };
  auto drain = [&]() {
    for (; consumed < issued; ++consumed)
      mbar_wait(bars + 8 * (consumed % kStages), (consumed / kStages) & 1);
  };

  int t = decide_from(0, false, 0);
  restart(t);
  for (int x = 0; x < kStages - 1; ++x) issue();
  if (resident) mbar_wait(qbar, 0);
  int jb = t < nsteps ? ld_pinned(order + s + splits * t) : 0;
  while (t < nsteps) {
    const int jb1 = t + 1 < nsteps ? ld_pinned(order + s + splits * (t + 1)) : 0;
    for (int sub = 0; sub < nsub; ++sub) {
      const int c0 = sub * kTileN;
      const int ncols = min(kTileN, bn - c0);
      const size_t col0 = (size_t)jb * bn + c0;
      // lane tx holds columns 4tx + {0..3}, 64 + 4tx + {0..3}; their
      // validity loads now and lands while the scores are computed
      unsigned colmask = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 4 * tx + (j & 3) + 64 * (j >> 2);
        colmask |= (c < ncols && prm.row_valid[col0 + c]) ? 1u << j : 0u;
      }
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
      for (int c = 0; c < nchunk; ++c) {
        mbar_wait(bars + 8 * (consumed % kStages), (consumed / kStages) & 1);
        __syncthreads();  // every warp is done with stage consumed - 1
        issue();
        const float* st = ring + (consumed % kStages) * stage;
        const int k0 = c * kStep;
        fma_panel(acc, resident ? qres + k0 * kTileM : st + kStageFloats,
                  reinterpret_cast<const T*>(st), min(kStep, d - k0), tx, ty);
        ++consumed;
      }

      // merge: the half-warp (warp, half) owns rows 4ty + {0..3} and
      // 64 + 4ty + {0..3}
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int r = 4 * ty + (a & 3) + 64 * (a >> 2);
        const float kth = thr_s[r];
        const bool rowok = r < rows;
        bool any = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) any |= ((colmask >> j) & 1u) && acc[a][j] > kth;
        if (!__any_sync(0xffffffffu, rowok && any)) continue;
        int nin = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool pass = rowok && ((colmask >> j) & 1u) && acc[a][j] > kth;
          const unsigned hm =
              (__ballot_sync(0xffffffffu, pass) >> (16 * half)) & 0xffffu;
          if (pass) {
            const int at = nin + __popc(hm & ((1u << tx) - 1u));
            cv[at] = acc[a][j];
            ci[at] = (int)col0 + 4 * tx + (j & 3) + 64 * (j >> 2);
          }
          nin += __popc(hm);
        }
        __syncwarp();
        if (nin > 0)
          merge_row(ts + (size_t)r * k, ti + (size_t)r * k, k, cv, ci, nin,
                    tx, hmask, thr_s + r);
        __syncwarp();
      }
    }
    __syncthreads();  // every row's τ and top-k after this tile
    const int tn = decide_from(t + 1, true, jb1);
    if (tn != t + 1) {  // the speculative loads were for a skipped tile
      drain();
      restart(tn);
      for (int x = 0; x < kStages - 1; ++x) issue();
    }
    jb = tn == t + 1 ? jb1 : (tn < nsteps ? ld_pinned(order + s + splits * tn) : 0);
    t = tn;
  }
  drain();  // no copy may land after the CTA leaves
  if constexpr (kFused) epilogue(prm);
}

// Reduce [splits, m, k] partial lists to [m, k]: score descending, then
// split, then slot, the unfused kernel's merge before the epilogue took
// its place (no engine path launches it; chip_smoke.py times it against
// the epilogue).  One warp per row; each entry's rank is its slot plus
// the entries of the other splits that precede it (binary search: the
// lists are descending).  Ranks are a permutation, so every slot is set.
__global__ void merge_splits_kernel(const float* ps, const int* pi,
                                    float* out_s, int* out_i, int m, int k,
                                    int splits) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;
  for (int e = lane; e < splits * k; e += 32) {
    const int s = e / k, j = e - s * k;
    const size_t at = ((size_t)s * m + row) * k + j;
    const float w = ps[at];
    int rank = j;
    for (int s2 = 0; s2 < splits && rank < k; ++s2) {
      if (s2 == s) continue;
      const float* list = ps + ((size_t)s2 * m + row) * k;
      int a = 0, b = k;
      while (a < b) {
        const int mid = (a + b) >> 1;
        const float x = list[mid];
        if (s2 < s ? x >= w : x > w) a = mid + 1; else b = mid;
      }
      rank += a;
    }
    if (rank < k) {
      out_s[(size_t)row * k + rank] = w;
      out_i[(size_t)row * k + rank] = pi[at];
    }
  }
}

template <bool kFused, typename T>
cudaError_t set_smem(size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      pruned_topk_kernel<kFused, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(pruned_topk_kernel<kFused, T>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename T>
int launch_typed(const Params& prm, size_t smem, dim3 grid, int fused,
                 cudaStream_t stream) {
  const cudaError_t err = fused ? set_smem<true, T>(smem) : set_smem<false, T>(smem);
  if (err != cudaSuccess) return (int)err;
  if (fused)
    pruned_topk_kernel<true, T><<<grid, kThreads, smem, stream>>>(prm);
  else
    pruned_topk_kernel<false, T><<<grid, kThreads, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" size_t pruned_topk_smem_bytes(int d, int p) {
  return sizeof(float) * smem_floats(d, p, q_resident(d, p));
}

// Resident CTAs per SM at (d, p), or -1 on a CUDA error.
extern "C" int pruned_topk_ctas_per_sm(int d, int p) {
  const size_t smem = pruned_topk_smem_bytes(d, p);
  if (set_smem<true, float>(smem) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, pruned_topk_kernel<true, float>, kThreads, smem) != cudaSuccess)
    return -1;
  return blocks;
}

// qt: [ceil(m / bm), d, 128] query tiles, k-major, rows past m zero;
// dbt: [n / bn * ceil(bn / 128), d, 128] db sub-tiles of 128 rows,
// k-major, rows past a tile's end zero, float (db_bf16 == 0) or bf16; lh: [n / bn, 2 * pp] each tile's
// pivot intervals, lo then hi, each padded to pp = p rounded up to 4.  All
// three 16-byte aligned.  top_s/top_i: [splits, m, k] scratch for the
// partial lists.  fused != 0: the epilogue merges them into out_s/out_i
// [m, k], row r to row row_out[r] (a permutation of [0, m); null: r), and
// arrive is [3, ceil(m / bm)] zeros, which the launch leaves holding each
// query tile's merge clock (see epilogue); fused == 0: the partial lists
// are the result and out_s, out_i, row_out and arrive are not read.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int pruned_topk_launch(
    const float* qt, const void* dbt, const float* qp, const float* lh,
    const float* tau, const int* block_order,
    const uint8_t* row_valid, const float* ub_cap, const float* dp,
    float* top_s, int* top_i, int* computed, int* elem, float* out_s,
    int* out_i, const int* row_out, unsigned* arrive, int m, int m_valid,
    int n, int d, int p, int k, int bm, int bn, int splits, float margin,
    int prune, int fused, int db_bf16, void* stream) {
  if (bm < 1 || bm > kTileM || p < 1 || p > kMaxPivots || k < 1 || k > bn ||
      k > kMaxK || bn < 1 || n % bn != 0 || m < 1 || d < 1 || splits < 1 ||
      splits > n / bn ||
      (fused && (out_s == nullptr || out_i == nullptr || arrive == nullptr)) ||
      ((uintptr_t)qt | (uintptr_t)dbt | (uintptr_t)lh) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Params prm{qt, dbt, qp, lh, tau, block_order, row_valid, ub_cap,
                   dp, top_s, top_i, out_s, out_i, row_out, arrive,
                   computed, elem, m, m_valid, d, p, k, bm, bn, n / bn,
                   margin, prune, q_resident(d, p)};
  const size_t smem = pruned_topk_smem_bytes(d, p);
  const dim3 grid((m + bm - 1) / bm, splits);
  return db_bf16 ? launch_typed<__nv_bfloat16>(prm, smem, grid, fused, (cudaStream_t)stream)
                 : launch_typed<float>(prm, smem, grid, fused, (cudaStream_t)stream);
}

extern "C" int merge_splits_launch(const float* part_s, const int* part_i,
                                   float* top_s, int* top_i, int m, int k,
                                   int splits, void* stream) {
  if (m < 1 || k < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const int rows_per_cta = kThreads / 32;
  merge_splits_kernel<<<(m + rows_per_cta - 1) / rows_per_cta, kThreads, 0,
                        (cudaStream_t)stream>>>(part_s, part_i, top_s, top_i,
                                                m, k, splits);
  return (int)cudaGetLastError();
}
