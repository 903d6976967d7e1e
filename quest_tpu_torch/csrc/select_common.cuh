// Page scoring and exact top-K page selection, shared by the streaming
// estimate (estimate.cu), the standalone select (topk_select.cu) and the
// fused decode kernel (fused_decode.cu), so all three run one copy.
//
// Scoring (quest_tpu/ops/estimate.py:_est_kernel and the scoring stage of
// quest_tpu/ops/fused_decode.py:_kernel): for a KV head's G query rows,
//   score[p] = agg_g( relu(q_g) . k_max[p] + min(q_g, 0) . k_min[p] )
// with relu(q) and min(q, 0) taken in f32 and rounded to the metadata
// dtype M (bf16 for fp8 metadata) before the products (as both JAX
// kernels cast them), products accumulated in f32, agg = max or sum over
// the G rows. The callers round the G query rows into shared memory.
// bf16 and fp8 metadata are scored on the tensor cores, 16 pages a warp
// (tile_scores); f32 metadata by FMAs, a "team" of 32 lanes a page, each
// reading 16 bytes of both rows, then a butterfly (team_score). Each is
// the one copy of its arithmetic, so the estimate and the fused kernel
// score bit for bit alike.
//
// Selection (quest_tpu/ops/fused_decode.py:_exact_topk_select and
// _compact_ids): scores map to order-preserving unsigned keys (the JAX
// int32 image b < 0 ? b ^ 0x7fffffff : b, offset by 2^31), so -0.0 orders
// below +0.0 as in JAX. A radix select of four 8-bit passes finds the
// exact k-th largest key T; the selection is every key > T plus the
// lowest-page keys == T up to k, and is written in ascending page order
// by a prefix count in page order. The fused kernel gathers its cluster's
// keys into every CTA and runs the same select there (fused_decode.cu).
#pragma once

#include <type_traits>

#include "common.cuh"

namespace qt {

constexpr int kHeadDim = 128;     // head dim the kernels take
constexpr int kSelThreads = 256;  // threads of a selecting CTA: one a bin
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kScoreTile = 16;   // pages a tensor-core scoring tile
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kKeyPosInf = 0xff800000u;  // order_key(+inf)

// The G query rows of one KV-head group rounded to M, in f32: since
// rounding keeps signs, relu(M(q)) = M(relu(q)) and min(M(q), 0) =
// M(min(q, 0)), so one row serves both halves of the split.
// q: [.., G, D] bf16 or f32; base: element offset of the group's row 0.
// Every thread of the CTA calls it; the caller syncs before reading qs.
template <typename M, int G>
__device__ __forceinline__ void round_query(const void* q, int q_bf16,
                                            int64_t base,
                                            float (*qs)[kHeadDim]) {
  for (int i = threadIdx.x; i < G * kHeadDim; i += blockDim.x) {
    const float x =
        q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[base + i])
               : static_cast<const float*>(q)[base + i];
    qs[i / kHeadDim][i % kHeadDim] = Elem<M>::round(x);
  }
}

// How a team of lanes reads one page's f32 metadata row (bf16 and fp8
// rows go to tile_scores): E elements a lane (one 16-byte load), L lanes
// a page.
template <typename M>
struct TeamRow {
  static_assert(sizeof(M) == 4, "bf16 and fp8 metadata: tile_scores");
  static constexpr int E = 4;
  static constexpr int L = kHeadDim / E;
  using Raw = uint4;

  __device__ __forceinline__ static void unpack(const Raw& raw, float* f) {
    Elem<M>::unpack(raw, f);
  }
};

// One page's aggregated score from this lane's E elements of the page's
// k_max and k_min rows (rx, rn as loaded): relu(q) . k_max + min(q, 0) .
// k_min with one product a dim (the other half's factor is 0), a
// butterfly over the team's L lanes, then max or sum over the G rows. The
// lane's E dims of query row g are q[g * qs + j] (qs = kHeadDim for the
// rows in shared memory, E for a copy in registers). Every lane of the
// team gets the score; every lane of the warp must call it (the
// shuffles).
template <typename M, int G>
__device__ __forceinline__ float team_score(const float* q, int qs,
                                            const typename TeamRow<M>::Raw& rx,
                                            const typename TeamRow<M>::Raw& rn,
                                            bool agg_sum) {
  constexpr int E = TeamRow<M>::E, L = TeamRow<M>::L;
  float fx[E], fn[E];
  TeamRow<M>::unpack(rx, fx);
  TeamRow<M>::unpack(rn, fn);
  float agg = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const float x = q[g * qs + j];
      s = fmaf(x, x > 0.f ? fx[j] : fn[j], s);
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    agg = g == 0 ? s : (agg_sum ? agg + s : fmaxf(agg, s));
  }
  return agg;
}

// Scores pages [0, npg) whose metadata rows lie in shared memory (page p's
// rows at smax/smin + p * kHeadDim): a team of L lanes a page, each team
// loading two pages before it scores them, the CTA's teams taking the
// pages in turn. q, qs: the lane's query dims as team_score takes them.
// sink(p, score) is called once a page, by the team's first lane. Every
// thread of the CTA must call it (the shuffles take the whole warp);
// blockDim.x is a multiple of 32.
template <typename M, int G, typename SinkFn>
__device__ __forceinline__ void score_rows(const M* smax, const M* smin,
                                           const float* q, int qs, int npg,
                                           bool agg_sum, SinkFn sink) {
  using Raw = typename TeamRow<M>::Raw;
  constexpr int L = TeamRow<M>::L, U = 2;
  const int lane = threadIdx.x & 31;
  const int team = (threadIdx.x >> 5) * (32 / L) + lane / L;
  const int nteams = (blockDim.x >> 5) * (32 / L);
  const int c = lane % L;
  for (int p0 = 0; p0 < npg; p0 += nteams * U) {  // the same in every lane
    Raw rx[U], rn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * nteams + team;
      rx[u] = rn[u] = Raw{};
      if (p < npg) {
        rx[u] = reinterpret_cast<const Raw*>(smax + p * kHeadDim)[c];
        rn[u] = reinterpret_cast<const Raw*>(smin + p * kHeadDim)[c];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * nteams + team;
      const float sc = team_score<M, G>(q, qs, rx[u], rn[u], agg_sum);
      if (p < npg && c == 0) sink(p, sc);
    }
  }
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *static_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a . b on the tensor cores: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), c 16 x 8 f32, in the m16n8k16 fragment layout.
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Scoring on the tensor cores, for bf16 and fp8 metadata (f32 metadata
// takes team_score): C[page][g] = sum over d of k_max[page][d] relu(q_g)[d]
// + k_min[page][d] min(q_g, 0)[d] by mma.sync m16n8k16, 16 pages a tile as
// the rows, the G query rows (padded to 8) as the columns, both halves
// into one f32 accumulator, then max or sum over the G columns. The rows
// are widened to bf16 (fp8 by the packed upcast_fp8 recipe); relu(q) and
// min(q, 0) of the rounded q are exact in bf16. The k dims are permuted,
// the same in A and B: step kk's lane tig takes dims step_dim(kk, tig) ..
// + 3, so a lane's two steps 2m and 2m + 1 read 8 consecutive elements of
// a row (one 16-byte load in bf16).
__device__ __forceinline__ int step_dim(int kk, int tig) {
  return 32 * (kk >> 1) + 8 * tig + 4 * (kk & 1);
}

template <int G>
struct QueryFrags {
  uint32_t b[16][2];  // steps 0-7: relu(q) (k_max); 8-15: min(q, 0) (k_min)

  // qs: the G rounded query rows in shared memory. Whole warp.
  __device__ __forceinline__ void load(const float (*qs)[kHeadDim]) {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
    const float* r = qs[gid < G ? gid : 0];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = gid < G ? r[step_dim(kk, tig) + j] : 0.f;
      b[kk][0] = pack_bf16(fmaxf(x[0], 0.f), fmaxf(x[1], 0.f));
      b[kk][1] = pack_bf16(fmaxf(x[2], 0.f), fmaxf(x[3], 0.f));
      b[8 + kk][0] = pack_bf16(fminf(x[0], 0.f), fminf(x[1], 0.f));
      b[8 + kk][1] = pack_bf16(fminf(x[2], 0.f), fminf(x[3], 0.f));
    }
  }
};

// The raw word a lane reads of a metadata row in tile_scores: the four
// elements of a step (step_dim).
template <typename M>
using RowWord = typename std::conditional<sizeof(M) == 2, uint2, uint32_t>::type;

// The lane's words of steps 2m and 2m + 1 of a row from global memory
// (read-only; p = the row + step_dim(2m, tig)), one load, asking L2 to
// fetch the whole 256-byte line on a miss: the tile's lanes read a row
// 64 bytes at a time, and a line fetched whole serves all of them.
template <typename M>
__device__ __forceinline__ void ldg_row_words(const M* p, RowWord<M>& w0,
                                              RowWord<M>& w1) {
  if constexpr (sizeof(M) == 2) {
    asm volatile("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(w0.x), "=r"(w0.y), "=r"(w1.x), "=r"(w1.y)
                 : "l"(p));
  } else {
    asm volatile("ld.global.nc.L2::256B.v2.u32 {%0, %1}, [%2];\n"
                 : "=r"(w0), "=r"(w1)
                 : "l"(p));
  }
}

// The scores of a tile of 16 pages: lane (gid = lane / 4, tig) gets pages
// gid (lo) and gid + 8 (hi), every lane of a quad alike. row(half, kk, r)
// gives the lane's RowWord of step kk of the k_max (half 0) or k_min
// (half 1) row of page gid + 8 r, from shared memory or registers. A page
// whose words are garbage only makes its own score garbage. Whole warp.
template <typename M, int G, typename RowFn>
__device__ __forceinline__ void tile_scores(RowFn row, const QueryFrags<G>& qf,
                                            bool agg_sum, float& lo,
                                            float& hi) {
  static_assert(sizeof(M) <= 2, "f32 metadata is scored by team_score");
  const int tig = threadIdx.x & 3;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t a[2][2];  // [page gid, gid + 8][dims 0-1, 2-3] as bf16 pairs
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const RowWord<M> w = row(half, kk, r);
        if constexpr (sizeof(M) == 2) {
          a[r][0] = w.x;
          a[r][1] = w.y;
        } else {
          fp8x4_to_bf16(w, a[r][0], a[r][1]);
        }
      }
      mma_bf16(c, a[0][0], a[1][0], a[0][1], a[1][1], qf.b[8 * half + kk][0],
               qf.b[8 * half + kk][1]);
    }
  }
  // Columns 2 tig and 2 tig + 1 are query rows (zeros past G).
  if (agg_sum) {
    lo = c[0] + c[1];
    hi = c[2] + c[3];
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      lo += __shfl_xor_sync(kFull, lo, o);
      hi += __shfl_xor_sync(kFull, hi, o);
    }
  } else {
    const bool v0 = 2 * tig < G, v1 = 2 * tig + 1 < G;
    lo = fmaxf(v0 ? c[0] : -INFINITY, v1 ? c[1] : -INFINITY);
    hi = fmaxf(v0 ? c[2] : -INFINITY, v1 ? c[3] : -INFINITY);
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      lo = fmaxf(lo, __shfl_xor_sync(kFull, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
    }
  }
}

// tile_scores' rows from shared memory: page i's k_max row at kx + i * rs,
// its k_min row at kn + i * rs (8-byte aligned in bf16, 4 in fp8).
template <typename M>
__device__ __forceinline__ auto smem_rows(const M* kx, const M* kn, int rs) {
  const int lane = threadIdx.x & 31, tig = lane & 3;
  const int off = (lane >> 2) * rs;
  return [=](int half, int kk, int r) {
    return *reinterpret_cast<const RowWord<M>*>(
        (half ? kn : kx) + off + r * 8 * rs + step_dim(kk, tig));
  };
}

// Order-preserving unsigned image of an f32 score.
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

struct SelectShared {
  unsigned hist[kSelWarps][256];  // one private histogram a warp
  unsigned wtot[kSelWarps];       // the bin scan's warp totals
  unsigned warp_cnt[64];          // per warp: ties (0..31), selected (32..63)
  unsigned thr;                   // the k-th largest key
  unsigned ties;                  // keys == thr among the k largest
};

// The k-th largest of keys[0, n) for 1 <= k <= n, exactly: four passes of
// 8-bit histograms from the top byte down, each over the keys that match
// the digits found so far. Each warp counts into its own histogram with
// shared-memory atomics (warp-aggregating equal digits with match_any was
// slower on the H100); thread t then owns bin 255 - t: it sums the warps'
// counts, and a scan over the threads counts the keys at or above each
// bin, so the thread whose bin holds the k_rem-th key finds the digit.
// Three CTA barriers a pass. Leaves sm.thr and sm.ties; every thread of a
// CTA of kSelThreads threads must call it.
__device__ __forceinline__ void radix_select(const unsigned* keys, int n,
                                             unsigned k, SelectShared& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned bin = 255u - tid;
  unsigned prefix = 0, mask = 0, k_rem = k;
#pragma unroll
  for (int w = 0; w < kSelWarps; ++w) sm.hist[w][tid] = 0;
  __syncthreads();
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i0 = 0; i0 < n; i0 += kSelThreads) {
      const int i = i0 + tid;
      unsigned d = 0;
      bool act = false;
      if (i < n) {
        const unsigned u = keys[i];
        act = (u & mask) == prefix;
        d = (u >> shift) & 255u;
      }
      if (act) atomicAdd(&sm.hist[warp][d], 1u);
    }
    __syncthreads();  // every warp's histogram is complete
    unsigned c = 0;
#pragma unroll
    for (int w = 0; w < kSelWarps; ++w) {
      c += sm.hist[w][bin];
      sm.hist[w][bin] = 0;  // ready for the next pass
    }
    unsigned incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) sm.wtot[warp] = incl;
    __syncthreads();  // the warp totals
    for (int v = 0; v < warp; ++v) incl += sm.wtot[v];
    // incl counts the keys in bins >= this one: one thread's bin holds the
    // k_rem-th largest.
    if (incl >= k_rem && incl - c < k_rem) {
      sm.thr = prefix | (bin << shift);
      sm.ties = k_rem - (incl - c);
    }
    __syncthreads();  // thr, ties
    prefix = sm.thr;
    k_rem = sm.ties;
    mask |= 255u << shift;
  }
}

// Writes the selected pages of keys[0, n) -- every key > thr, then the
// first `ties` keys == thr in page order -- to ids[0, ...) in ascending
// page order; no slot >= K is written. Each warp takes one contiguous
// range of pages: one pass counts its keys > thr and == thr, and after one
// CTA barrier the counts of the warps before it give its first slot and
// its share of the ties; a second pass writes. Every thread must call it;
// the caller syncs before reading ids.
__device__ __forceinline__ void compact_selected(const unsigned* keys, int n,
                                                 unsigned thr, unsigned ties,
                                                 int* ids, int K,
                                                 SelectShared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int span = ((n + nwarps - 1) / nwarps + 31) & ~31;
  const int lo = warp * span, hi = min(n, lo + span);
  const unsigned lt = (1u << lane) - 1u;

  unsigned gt = 0, eq = 0;
  for (int p0 = lo; p0 < hi; p0 += 32) {
    const int p = p0 + lane;
    const unsigned key = p < hi ? keys[p] : 0u;
    gt += __popc(__ballot_sync(kFull, p < hi && key > thr));
    eq += __popc(__ballot_sync(kFull, p < hi && key == thr));
  }
  if (lane == 0) {
    sm.warp_cnt[warp] = eq;
    sm.warp_cnt[32 + warp] = gt;
  }
  __syncthreads();
  unsigned tie_run = 0, slot = 0;
  for (int v = 0; v < warp; ++v) {
    const unsigned e = sm.warp_cnt[v];
    slot += sm.warp_cnt[32 + v] + min(e, ties - min(ties, tie_run));
    tie_run += e;
  }
  for (int p0 = lo; p0 < hi; p0 += 32) {
    const int p = p0 + lane;
    const unsigned key = p < hi ? keys[p] : 0u;
    const bool tie = p < hi && key == thr;
    const unsigned tb = __ballot_sync(kFull, tie);
    const bool sel =
        p < hi && (key > thr || (tie && tie_run + __popc(tb & lt) < ties));
    const unsigned sb = __ballot_sync(kFull, sel);
    if (sel) {
      const unsigned s = slot + __popc(sb & lt);
      if (s < static_cast<unsigned>(K)) ids[s] = p;
    }
    tie_run += __popc(tb);
    slot += __popc(sb);
  }
}

}  // namespace qt
