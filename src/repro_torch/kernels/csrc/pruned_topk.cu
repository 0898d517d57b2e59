// Fused block-pruned exact cosine top-k for Hopper (sm_90a), fp32 SIMT.
//
// Replaces the TPU kernel src/repro/kernels/cosine_topk.py:pruned_topk
// (body _make_kernel, pallas_call at cosine_topk.py:310).  It computes
// what that kernel computes: per (query tile, db tile) in block_order
// visit order, the Eq. 13 interval bound (min over pivots, optionally
// min'd with ub_cap), a skip test against every row's running k-th best
// τ, and for tiles that survive the fp32 scores q @ dbᵀ merged into a
// running top-k.  Outputs match the reference slot for slot: computed and
// elem are indexed by db tile id, not by visit step.
//
// Grid and loop.  One CTA per query tile of bm <= 128 rows.  The TPU's
// sequential grid axis over db tiles becomes a loop inside the CTA that
// reads block_order[i, j] itself, so each query tile keeps the reference's
// visit order and `computed` stays comparable one to one.  The running
// top-k lives in the output arrays (global memory, L2-resident): it holds
// any k <= bn without limiting shared memory.
//
// What bounds it on the H100.  A computed tile is 2·bm·bn·D fp32 flops
// against bn·D·4 bytes of db rows (64 flops per byte at bm = 128): the
// fp32 SIMT rate (67 TFLOP/s) bounds it, not HBM.  No tensor cores and no
// TF32: the reference guards fp32 scores with margin = 4e-7 and seeds τ
// 1e-6 below the prescan value, and TF32 keeps about 3 digits.  The K-loop
// stages D in chunks of 32 through shared memory (the TPU kept D whole in
// VMEM; 227 KB of shared memory cannot hold a 128-row tile at large D),
// and each thread accumulates an 8x8 register tile.
//
// Known limit: parallelism is ceil(M / bm) CTAs (79 at 10,000 queries on
// 132 SMs).  Splitting the db axis across CTAs and wgmma scores are later
// work.
//
// Bounds come from eq13.cuh, rounded op by op so they equal the plain
// PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "eq13.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileM = 128;        // max query rows per CTA
constexpr int kTileN = 128;        // db rows per score sub-tile
constexpr int kChunk = 32;         // feature columns per K-loop step
constexpr int kPadM = kTileM + 1;  // +1: conflict-free transposed stores
constexpr int kPadN = kTileN + 1;
constexpr int kMaxPivots = 64;

struct Params {
  const float* qn;              // [m, d]
  const float* db;              // [n, d]
  const float* qp;              // [m, p]
  const float* lo;              // [nt, p]
  const float* hi;              // [nt, p]
  const float* tau;             // [m] seeds (already lowered), -inf if none
  const int* block_order;       // [mt, nt]
  const uint8_t* row_valid;     // [n]
  const float* ub_cap;          // [m, nt] or null
  const float* dp;              // [n, p] or null (element stats)
  float* top_s;                 // [m, k] running top-k, then the result
  int* top_i;                   // [m, k]
  int* computed;                // [mt, nt]
  int* elem;                    // [mt, nt] or null
  int m, m_valid, n, d, p, k, bm, bn, nt;
  float margin;
  int prune;
};

// Merge one row's new scores into its running top-k (sorted descending).
// The result is the first k of a stable descending sort of
// concat(existing, new): an existing slot beats an equal new score and a
// lower column beats a higher one, as the reference's argmax extraction
// over concat([top, scores]).  Only scores strictly above the current k-th
// value can enter; slots that stay -inf keep id -1.  One warp per row.
__device__ void merge_row(const float* srow, int ncols, int colbase,
                          float* ts, int* ti, int k, float* cv, int* ci,
                          float* ev, int* ei, int lane) {
  const float kth = ts[k - 1];
  int n_in = 0;
  for (int c0 = 0; c0 < ncols; c0 += 32) {
    const int c = c0 + lane;
    const float v = c < ncols ? srow[c] : -INFINITY;
    const bool enter = v > kth;
    const unsigned mask = __ballot_sync(0xffffffffu, enter);
    if (enter) {
      const int at = n_in + __popc(mask & ((1u << lane) - 1u));
      cv[at] = v;
      ci[at] = colbase + c;
    }
    n_in += __popc(mask);
  }
  __syncwarp();
  if (n_in == 0) return;
  for (int s = lane; s < k; s += 32) {
    ev[s] = ts[s];
    ei[s] = ti[s];
  }
  __syncwarp();
  // an existing slot moves down by the entering scores strictly above it
  for (int s = lane; s < k; s += 32) {
    const float v = ev[s];
    int pos = s;
    for (int e = 0; e < n_in; ++e) pos += cv[e] > v;
    if (pos < k) {
      ts[pos] = v;
      ti[pos] = ei[s];
    }
  }
  // an entering score goes after every existing slot >= it (binary search
  // over the descending list) and every earlier entering score >= it
  for (int e = lane; e < n_in; e += 32) {
    const float w = cv[e];
    int a = 0, b = k;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (ev[mid] >= w) a = mid + 1; else b = mid;
    }
    int pos = a;
    for (int f = 0; f < n_in; ++f) {
      const float x = cv[f];
      pos += (x > w) || (x == w && f < e);
    }
    if (pos < k) {
      ts[pos] = w;
      ti[pos] = ci[e];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
pruned_topk_kernel(const Params prm) {
  extern __shared__ float smem[];
  const int p = prm.p, k = prm.k, bm = prm.bm, bn = prm.bn, nt = prm.nt;
  float* qs = smem;                          // [kChunk][kPadM]
  float* ds = qs + kChunk * kPadM;           // [kChunk][kPadN]
  float* sc = ds + kChunk * kPadN;           // [kTileM][kPadN] scores
  float* qp_s = sc + kTileM * kPadN;         // [kTileM][p]
  float* rq_s = qp_s + kTileM * p;           // [kTileM][p] 1 - qp^2, clamped
  float* tau_s = rq_s + kTileM * p;          // [kTileM] τ at tile start
  float* lo_s = tau_s + kTileM;              // [p]
  float* hi_s = lo_s + p;                    // [p]
  float* wbuf = hi_s + p;                    // per warp: cv, ci, ev, ei
  const int wstride = 2 * kTileN + 2 * k;
  int* red = reinterpret_cast<int*>(wbuf + kWarps * wstride);  // [kWarps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int i = blockIdx.x;
  const int row0 = i * bm;
  const int rows = min(bm, prm.m - row0);
  float* cv = wbuf + warp * wstride;
  int* ci = reinterpret_cast<int*>(cv + kTileN);
  float* ev = cv + 2 * kTileN;
  int* ei = reinterpret_cast<int*>(ev + k);

  for (int e = tid; e < rows * k; e += kThreads) {
    const int r = e / k;
    prm.top_s[(size_t)row0 * k + e] = prm.tau[row0 + r];
    prm.top_i[(size_t)row0 * k + e] = -1;
  }
  for (int e = tid; e < kTileM * p; e += kThreads) {
    const int r = e / p;
    const float a = r < rows ? prm.qp[(size_t)(row0 + r) * p + e % p] : 1.f;
    qp_s[e] = a;
    rq_s[e] = radicand(a);
  }

  for (int j = 0; j < nt; ++j) {
    const int jb = prm.block_order[(size_t)i * nt + j];
    for (int e = tid; e < p; e += kThreads) {
      lo_s[e] = prm.lo[(size_t)jb * p + e];
      hi_s[e] = prm.hi[(size_t)jb * p + e];
    }
    __syncthreads();  // also publishes the previous tile's merges

    // 1. Eq. 13 tile bound per row and the skip test
    bool pred = false;
    if (tid < bm) {
      const int r = tid;
      const float tau = r < rows ? prm.top_s[(size_t)(row0 + r) * k + k - 1]
                                 : -INFINITY;
      tau_s[r] = tau;
      float ub = 0.f;
      for (int q = 0; q < p; ++q) {
        const float a = qp_s[r * p + q], ra = rq_s[r * p + q];
        const float l = lo_s[q], h = hi_s[q];
        const float per = (a >= l && a <= h)
            ? 1.f : nan_max(ub_mult(a, ra, l), ub_mult(a, ra, h));
        ub = q == 0 ? per : nan_min(ub, per);
      }
      if (prm.ub_cap != nullptr)
        ub = nan_min(ub, r < rows ? prm.ub_cap[(size_t)(row0 + r) * nt + jb]
                                  : 0.f);
      const bool live = row0 + r < prm.m_valid;
      pred = live && (__fadd_rn(ub, prm.margin) >= tau);
    }
    const int needed = prm.prune ? __syncthreads_or(pred) : 1;
    if (!prm.prune) __syncthreads();
    if (tid == 0) prm.computed[(size_t)i * nt + jb] = needed;

    // 2. per-(query, row) Eq. 13 bound against τ, skipped tile or not
    if (prm.elem != nullptr) {
      int cnt = 0;
      for (int e = tid; e < bm * bn; e += kThreads) {
        const int r = e / bn, c = e % bn;
        const size_t row = (size_t)jb * bn + c;
        if (row0 + r >= prm.m_valid || !prm.row_valid[row]) continue;
        float eub = 0.f;
        for (int q = 0; q < p; ++q) {
          const float cand = ub_mult(qp_s[r * p + q], rq_s[r * p + q],
                                     prm.dp[row * p + q]);
          eub = q == 0 ? cand : nan_min(eub, cand);
        }
        cnt += __fadd_rn(eub, prm.margin) < tau_s[r];
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
    if (!needed) continue;

    // 3. scores of the surviving tile, 128 db rows at a time, and the merge
    for (int c0 = 0; c0 < bn; c0 += kTileN) {
      const int ncols = min(kTileN, bn - c0);
      const size_t col0 = (size_t)jb * bn + c0;
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
      for (int k0 = 0; k0 < prm.d; k0 += kChunk) {
        for (int e = tid; e < kTileM * kChunk; e += kThreads) {
          const int r = e / kChunk, kk = e % kChunk;
          qs[kk * kPadM + r] = (r < rows && k0 + kk < prm.d)
              ? prm.qn[(size_t)(row0 + r) * prm.d + k0 + kk] : 0.f;
        }
        for (int e = tid; e < kTileN * kChunk; e += kThreads) {
          const int c = e / kChunk, kk = e % kChunk;
          ds[kk * kPadN + c] = (c < ncols && k0 + kk < prm.d)
              ? prm.db[(col0 + c) * prm.d + k0 + kk] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kChunk; ++kk) {
          float a[8], b[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) a[u] = qs[kk * kPadM + ty + 16 * u];
#pragma unroll
          for (int u = 0; u < 8; ++u) b[u] = ds[kk * kPadN + tx + 16 * u];
#pragma unroll
          for (int u = 0; u < 8; ++u)
#pragma unroll
            for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const int c = tx + 16 * v;
          if (c < ncols)
            sc[(ty + 16 * u) * kPadN + c] =
                prm.row_valid[col0 + c] ? acc[u][v] : -INFINITY;
        }
      __syncthreads();
      for (int r = warp; r < rows; r += kWarps)
        merge_row(sc + r * kPadN, ncols, (int)col0,
                  prm.top_s + (size_t)(row0 + r) * k,
                  prm.top_i + (size_t)(row0 + r) * k, k, cv, ci, ev, ei, lane);
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" size_t pruned_topk_smem_bytes(int p, int k) {
  return sizeof(float) * ((size_t)kChunk * kPadM + (size_t)kChunk * kPadN +
                          (size_t)kTileM * kPadN + 2 * (size_t)kTileM * p +
                          kTileM + 2 * (size_t)p +
                          (size_t)kWarps * (2 * kTileN + 2 * k) + kWarps);
}

// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int pruned_topk_launch(
    const float* qn, const float* db, const float* qp, const float* lo,
    const float* hi, const float* tau, const int* block_order,
    const uint8_t* row_valid, const float* ub_cap, const float* dp,
    float* top_s, int* top_i, int* computed, int* elem, int m, int m_valid,
    int n, int d, int p, int k, int bm, int bn, float margin, int prune,
    void* stream) {
  if (bm < 1 || bm > kTileM || p < 1 || p > kMaxPivots || k < 1 || k > bn ||
      bn < 1 || n % bn != 0 || m < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  const Params prm{qn, db, qp, lo, hi, tau, block_order, row_valid, ub_cap, dp,
                   top_s, top_i, computed, elem, m, m_valid, n, d, p, k, bm,
                   bn, n / bn, margin, prune};
  const size_t smem = pruned_topk_smem_bytes(p, k);
  cudaError_t err = cudaFuncSetAttribute(
      pruned_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int mt = (m + bm - 1) / bm;
  pruned_topk_kernel<<<mt, kThreads, smem, (cudaStream_t)stream>>>(prm);
  return (int)cudaGetLastError();
}
