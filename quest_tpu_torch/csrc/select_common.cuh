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
// the G rows. A "team" of lanes reads one page's two metadata rows with
// one 16-byte load per lane each (8 lanes in fp8, 16 in bf16, 32 in f32)
// and reduces by shuffles.
//
// Selection (quest_tpu/ops/fused_decode.py:_exact_topk_select and
// _compact_ids): scores map to order-preserving unsigned keys (the JAX
// int32 image b < 0 ? b ^ 0x7fffffff : b, offset by 2^31), so -0.0 orders
// below +0.0 as in JAX. A radix select of four 8-bit passes finds the
// exact k-th largest key T; the selection is every key > T plus the
// lowest-page keys == T up to k, and is written in ascending page order
// by a prefix count in page order.
#pragma once

#include "common.cuh"

namespace qt {

constexpr int kHeadDim = 128;     // head dim the kernels take
constexpr int kSelThreads = 128;  // threads of a scoring / selecting CTA
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kKeyPosInf = 0xff800000u;  // order_key(+inf)

// The query rows of one KV-head group as one lane of a team holds them:
// dims [c * CH, c * CH + CH) of each of the G rows, c = lane % kLanes.
template <typename M, int G>
struct SplitQuery {
  static constexpr int CH = Elem<M>::kPerChunk;  // 16 fp8, 8 bf16, 4 f32
  static constexpr int kLanes = kHeadDim / CH;   // lanes a page: 8, 16, 32
  float pos[G][CH], neg[G][CH];

  // q: [.., G, D] bf16 or f32; base: element offset of the group's row 0.
  __device__ __forceinline__ void load(const void* q, int q_bf16, int64_t base,
                                       int c) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int64_t i = base + g * kHeadDim + c * CH + j;
        const float x =
            q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i])
                   : static_cast<const float*>(q)[i];
        pos[g][j] = Elem<M>::round(fmaxf(x, 0.f));
        neg[g][j] = Elem<M>::round(fminf(x, 0.f));
      }
    }
  }
};

// One page's aggregated score from this lane's 16 bytes of its k_max and
// k_min rows; every lane of the team gets it.
template <typename M, int G>
__device__ __forceinline__ float team_score(const SplitQuery<M, G>& sq,
                                            const uint4& rmax,
                                            const uint4& rmin, bool agg_sum) {
  constexpr int CH = SplitQuery<M, G>::CH, L = SplitQuery<M, G>::kLanes;
  float fx[CH], fn[CH];
  Elem<M>::unpack(rmax, fx);
  Elem<M>::unpack(rmin, fn);
  float agg = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j) s = fmaf(sq.pos[g][j], fx[j], s);
#pragma unroll
    for (int j = 0; j < CH; ++j) s = fmaf(sq.neg[g][j], fn[j], s);
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    agg = g == 0 ? s : (agg_sum ? agg + s : fmaxf(agg, s));
  }
  return agg;
}

// Scores pages [lo, hi) of one KV head. Each warp takes U pages a team in
// turn, issuing all U pages' loads before it uses them. row(p) is the
// element offset of page p's metadata row in kmax/kmin; sink(p, score) is
// called once a page, by the team's first lane. Every warp of the CTA
// must call it (the shuffles take the whole warp).
template <typename M, int G, int U, typename RowFn, typename SinkFn>
__device__ __forceinline__ void score_pages(const M* kmax, const M* kmin,
                                            const SplitQuery<M, G>& sq, int lo,
                                            int hi, bool agg_sum, RowFn row,
                                            SinkFn sink) {
  constexpr int CH = SplitQuery<M, G>::CH, L = SplitQuery<M, G>::kLanes;
  constexpr int TPW = 32 / L;  // teams a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int team = lane / L, c = lane % L;
  for (int p0 = lo + warp * TPW * U; p0 < hi; p0 += nwarps * TPW * U) {
    uint4 rx[U], rn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * TPW + team;
      rx[u] = rn[u] = make_uint4(0, 0, 0, 0);
      if (p < hi) {
        const int64_t off = row(p) + c * CH;
        rx[u] = __ldg(reinterpret_cast<const uint4*>(kmax + off));
        rn[u] = __ldg(reinterpret_cast<const uint4*>(kmin + off));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * TPW + team;
      const float s = team_score<M, G>(sq, rx[u], rn[u], agg_sum);
      if (p < hi && c == 0) sink(p, s);
    }
  }
}

// Order-preserving unsigned image of an f32 score.
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

struct SelectShared {
  unsigned hist[256];
  unsigned warp_cnt[64];  // per warp: ties (0..31), selected (32..63)
  unsigned thr;           // the k-th largest key
  unsigned ties;          // keys == thr among the k largest
};

// The k-th largest of keys[0, n) for 1 <= k <= n, exactly: four passes of
// 8-bit histograms from the top byte down, each over the keys that match
// the digits found so far. Lanes with equal digits add to the histogram
// once (match_any), since near-equal scores share their top bytes.
// Leaves sm.thr and sm.ties; every thread of the CTA must call it.
__device__ __forceinline__ void radix_select(const unsigned* keys, int n,
                                             unsigned k, SelectShared& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned prefix = 0, mask = 0, k_rem = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += blockDim.x) sm.hist[i] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += blockDim.x) {
      const int i = i0 + tid;
      unsigned d = 0;
      bool act = false;
      if (i < n) {
        const unsigned u = keys[i];
        act = (u & mask) == prefix;
        d = (u >> shift) & 255u;
      }
      const unsigned am = __ballot_sync(kFull, act);
      if (act) {
        const unsigned peers = __match_any_sync(am, d);
        if (lane == __ffs(peers) - 1) atomicAdd(&sm.hist[d], __popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {
      // Lane l holds digits 255-8l down to 248-8l; an inclusive scan over
      // the lanes counts the keys at or above each lane's digits.
      unsigned c[8], tot = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = sm.hist[255 - 8 * lane - j];
        tot += c[j];
      }
      unsigned incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned hit = __ballot_sync(kFull, incl >= k_rem);
      const int owner = hit ? __ffs(hit) - 1 : 31;
      if (lane == owner) {
        unsigned cum = incl - tot;
        int digit = 248 - 8 * lane;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (cum + c[j] >= k_rem) {
            digit = 255 - 8 * lane - j;
            break;
          }
          cum += c[j];
        }
        sm.thr = prefix | (static_cast<unsigned>(digit) << shift);
        sm.ties = k_rem - cum;
      }
    }
    __syncthreads();
    prefix = sm.thr;
    k_rem = sm.ties;
    mask |= 255u << shift;
  }
}

// Writes the selected pages of keys[0, n) -- every key > thr, then the
// first `ties` keys == thr in page order -- to ids[0, ...) in ascending
// page order; no slot >= K is written. Each warp counts one contiguous
// range of pages, so the page-order prefix needs only two CTA barriers.
// Every thread must call it; the caller syncs before reading ids.
__device__ __forceinline__ void compact_selected(const unsigned* keys, int n,
                                                 unsigned thr, unsigned ties,
                                                 int* ids, int K,
                                                 SelectShared& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int span = ((n + nwarps - 1) / nwarps + 31) & ~31;
  const int lo = warp * span, hi = min(n, lo + span);
  const unsigned lt = (1u << lane) - 1u;

  unsigned cnt = 0;
  for (int p0 = lo; p0 < hi; p0 += 32) {
    const int p = p0 + lane;
    cnt += __popc(__ballot_sync(kFull, p < hi && keys[p] == thr));
  }
  if (lane == 0) sm.warp_cnt[warp] = cnt;
  __syncthreads();
  unsigned tie_base = 0;
  for (int v = 0; v < warp; ++v) tie_base += sm.warp_cnt[v];

  // Pass 1 counts this warp's selected pages; pass 2 writes them.
  unsigned slot = 0;
  for (int pass = 0; pass < 2; ++pass) {
    unsigned tie_run = tie_base, nsel = 0;
    for (int p0 = lo; p0 < hi; p0 += 32) {
      const int p = p0 + lane;
      const unsigned key = p < hi ? keys[p] : 0u;
      const bool tie = p < hi && key == thr;
      const unsigned tb = __ballot_sync(kFull, tie);
      const bool sel =
          p < hi && (key > thr || (tie && tie_run + __popc(tb & lt) < ties));
      const unsigned sb = __ballot_sync(kFull, sel);
      if (pass == 1 && sel) {
        const unsigned s = slot + nsel + __popc(sb & lt);
        if (s < static_cast<unsigned>(K)) ids[s] = p;
      }
      tie_run += __popc(tb);
      nsel += __popc(sb);
    }
    if (pass == 0) {
      if (lane == 0) sm.warp_cnt[32 + warp] = nsel;
      __syncthreads();
      for (int v = 0; v < warp; ++v) slot += sm.warp_cnt[32 + v];
    }
  }
}

}  // namespace qt
