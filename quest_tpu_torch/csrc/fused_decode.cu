// Fused Quest decode: estimate -> exact top-K -> ascending compaction ->
// gather -> flash decode, in one launch.
//
// Replaces quest_tpu/ops/fused_decode.py:fused_sparse_decode (the Pallas
// kernel _kernel at line 240, pallas_call at line 606) in its shared
// whole-pool mode: one layer of the pool [Hkv, NP, 2, page, D] and of the
// physical-page metadata [Hkv, NP, D], logical pages mapped through the
// block table. It computes what _kernel computes; the TPU kernel's
// sequential grid, DMA rings and band reductions have no counterpart.
//
// Design: one cluster of kCluster CTAs per (batch row, KV head); CTA rank
// j owns the contiguous logical pages [j * per, (j + 1) * per) of the
// row's n valid pages. A CTA holds under half an SM's shared memory: the
// card fits 15 clusters of 8 at one CTA an SM but 30 at two, so B=2 x 8
// KV heads run in one wave.
//   1. Scoring. Thread 0 brings the CTA's k_max / k_min rows into a ring
//      of kScoreSlots shared-memory stages with bulk async copies, one a
//      run of physically contiguous pages (a block of the table holds
//      block_pages of them), all stages that fit issued before any is
//      used; the warps score from shared memory (the estimate's device
//      code, select_common.cuh: bf16 metadata on the tensor cores, a tile
//      of 16 pages a warp; f32 by FMAs) into order-preserving keys at the
//      pages' places in a row-wide key array.
//      The last page's key is +inf. The CTA then stores its keys into the
//      key array of every peer (distributed shared memory; each CTA
//      announces at its start that its shared memory is live, and waits
//      for its peers' word before the first remote store).
//   2. Select. After one cluster barrier every CTA holds the row's keys
//      and runs the standalone select's radix select and compaction
//      (select_common.cuh) over the whole row by itself: every CTA finds
//      the same ascending ids and keeps its share of the slots. (A
//      select split across the cluster would cost a cluster barrier and a
//      round of peer reads for each of its four passes; pushing the keys
//      costs one barrier.)
//   3. Attention over the CTA's share of the min(K, n) selected pages, cut
//      into chunks of TC tokens: warp w takes chunks w, w + 8, ..., loads
//      a chunk's K and V rows with 16-byte cp.async into a padded buffer
//      of its own and attends the G query heads over it with its own
//      online softmax, so no CTA barrier sits in the loop and the warps'
//      loads overlap each other's products. Over a bf16 pool and bf16
//      metadata (the serving path) QK^T and PV run on the tensor cores
//      (mma.sync m16n8k16, the heads padded to 16 rows); otherwise on
//      FMAs (QK a lane a token, PV a lane 4 dims).
//   4. Merge: the warps' partials merge in shared memory, each CTA stores
//      head g's partial into the shared memory of rank g % 8, and after
//      one cluster barrier each CTA merges its heads by log-sum-exp from
//      its own shared memory and writes them. Nothing reads a peer after
//      that barrier, so a CTA may then finish.
// Every CTA reaches every cluster barrier: nothing in it returns early.
// Numerics are the JAX fused kernel's, not the sparse kernel's: q is
// rounded to the metadata dtype M and NOT scaled (sm_scale multiplies the
// f32 QK scores); K and V are cast to M; p is rounded to M before PV and
// l sums the unrounded p. A slot's tokens are masked by their position
// (page * page_size + e < seq_len), which masks the last page's tail
// wherever compaction put it, as _kernel's slot arithmetic does.
//
// Bound on the H100: bytes. The kernel must read the valid metadata once
// (2 x 256 B a page in bf16) and the selected K/V once (8 KB a page at
// page 16): 27 MB for B=2, 8 KV heads, 32768 + 7001 tokens and 128 pages
// selected, about 8 us at 3.35 TB/s. Clusters spread each head over 8
// CTAs (128 at B=2, where one CTA a head would make 16). What the
// design cannot hide is its chain: the scoring's loads, the key barrier,
// the select, the attention's loads and the merge barrier.
#include <cooperative_groups.h>

#include "select_common.cuh"

namespace cg = cooperative_groups;

namespace qt {

constexpr int kCluster = 8;                 // CTAs a (batch row, KV head)
constexpr int kMaxBudget = 256;             // selection slots (the model's gate)
constexpr int kFusedThreads = kSelThreads;  // the select's CTA: thread t, bin t
constexpr int kWarps = kFusedThreads / 32;
constexpr int kScoreSlots = 4;              // scoring ring: stages of k_max + k_min
constexpr int kScoreSlotBytes = 16 << 10;

// One warp's attention chunk of pool dtype T: TC tokens' K rows and V
// rows, each padded by one 16-byte load, so that lanes reading the same
// columns of different rows (QK, ldmatrix) hit different banks.
template <typename T>
struct AttnChunk {
  static constexpr int CH = Elem<T>::kPerChunk;        // elements a load
  static constexpr int CPR = kHeadDim / CH;            // loads a row
  static constexpr int TC = sizeof(T) == 2 ? 16 : 8;   // tokens a chunk
  static constexpr int STR = kHeadDim + CH;            // padded row
  static constexpr int kBytes = 2 * TC * STR * sizeof(T);
};

constexpr int kWarpBytes =
    AttnChunk<float>::kBytes > AttnChunk<__nv_bfloat16>::kBytes
        ? AttnChunk<float>::kBytes
        : AttnChunk<__nv_bfloat16>::kBytes;
constexpr int kRingBytes = kWarps * kWarpBytes > kScoreSlots * kScoreSlotBytes
                               ? kWarps * kWarpBytes
                               : kScoreSlots * kScoreSlotBytes;
static_assert(kWarpBytes % 16 == 0, "warp buffers stay 16-byte aligned");

struct FusedArgs {
  const void* q;         // [B, Hkv*G, D] un-scaled, bf16 or f32
  const void* kv;        // one layer of the pool [Hkv, NP, 2, page, D]
  const void* kmax;      // one layer of the metadata [Hkv, NP, D]
  const void* kmin;
  const int* tab;        // [B, NB]
  const int* seq_lens;   // [B], the current token included
  float* out;            // [B, Hkv*G, D]
  int* ids_out;          // [B, Hkv, K] selected ids, or null
  int Hkv, NP, page, NB, bpp, K;
  float sm_scale;
  int agg_sum, q_bf16;
};

template <int G>
struct FusedShared {
  __align__(16) float qs[G][kHeadDim];  // q rounded to M, un-scaled
  float ps[kWarps][G][32];       // each warp's chunk probabilities
  float wm[kWarps][G];           // each warp's softmax state
  float wl[kWarps][G];
  float ww[G][kWarps];           // the warps' merge weights
  float m[G];                    // the CTA's softmax maximum of each head
  // Received partials of the heads this CTA merges (g = rank, rank + 8,
  // ...), one a rank: numerators and softmax state (peers write).
  float rpart[(G + kCluster - 1) / kCluster][kCluster][kHeadDim];
  float rm[(G + kCluster - 1) / kCluster][kCluster];
  float rl[(G + kCluster - 1) / kCluster][kCluster];
  int sel[kMaxBudget];           // the selected ids, ascending
  SelectShared sm;
  __align__(8) uint64_t bars[kScoreSlots];
};

#ifdef QT_FUSED_STAGES
// Stage clock, built only by quest_tpu_torch/exp/fused_stages.py: thread 0
// of every CTA reads the SM's cycle counter at the kernel's start, after
// the scoring, after the key barrier, after the radix select, after the
// compaction, after its warp's first attention chunk has landed, after
// the attention and at the end, into g_stamps[cta * kStamps + i] (i < 8),
// and the global nanosecond timer at the start and the end (i = 8, 9),
// which give the clock's rate and the span of the grid.
constexpr int kStamps = 10;
__device__ long long* g_stamps;
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define QT_STAMP_AT(i, v)                                               \
  do {                                                                  \
    if (threadIdx.x == 0 && g_stamps != nullptr)                        \
      g_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * kStamps + (i)] = \
          (v);                                                          \
  } while (0)
#define QT_STAMP(i) QT_STAMP_AT(i, clock64())
#define QT_STAMP_NS(i) QT_STAMP_AT(i, global_ns())
#else
#define QT_STAMP(i)
#define QT_STAMP_NS(i)
#endif

// Four pool elements from shared memory as f32 (8 bytes of bf16, 16 of
// f32).
template <typename T>
__device__ __forceinline__ void load4(const T* p, float* f) {
  if constexpr (sizeof(T) == 2) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    f[0] = lo.x;
    f[1] = lo.y;
    f[2] = hi.x;
    f[3] = hi.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
}

// Four 8 x 8 bf16 matrices from shared memory, transposed (the B operand
// of mma_bf16 from a row-major [k][n] tile); lane l gives the address of
// row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row)));
}

// The two halves of a cluster barrier: arrive (relaxed: orders nothing)
// and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// T: pool dtype; M: metadata dtype, also the dtype QK and PV run in.
template <typename T, typename M, int G>
__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kFusedThreads, 2) fused_decode_kernel(FusedArgs a) {
  using C = AttnChunk<T>;
  constexpr int CH = C::CH, CPR = C::CPR, TC = C::TC, STR = C::STR;
  // Pool values are rounded to M only where M is narrower (f32 pool, bf16
  // metadata; bf16 -> f32 is exact).
  constexpr bool kRoundKV = sizeof(T) > sizeof(M);
  // bf16 pool and metadata (the serving path): QK and PV on the tensor
  // cores; otherwise FMAs.
  constexpr bool kMma = sizeof(T) == 2 && sizeof(M) == 2;
  constexpr int ROW = kHeadDim * sizeof(M);        // metadata row bytes
  constexpr int SP = kScoreSlotBytes / (2 * ROW);  // pages a scoring stage
  constexpr int DL = kHeadDim / 32;                // PV: dims a lane

  // keys [P] (the row's, by logical page), the row's block table [NB],
  // then the ring (scoring stages, then the warps' attention buffers).
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ FusedShared<G> fs;

  QT_STAMP_NS(8);
  QT_STAMP(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / kCluster, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = a.NB * a.bpp;
  unsigned* keys = reinterpret_cast<unsigned*>(dyn);
  int* tab = reinterpret_cast<int*>(keys + P);
  const uint32_t head_end = smem_u32(tab + a.NB);
  unsigned char* ring = dyn + (((head_end + 127) & ~127u) - smem_u32(dyn));

  for (int i = tid; i < a.NB; i += blockDim.x) tab[i] = a.tab[b * a.NB + i];
  if (tid == 0) {
    for (int s = 0; s < kScoreSlots; ++s) bar_init(&fs.bars[s], 1);
    fence_barrier_init();
  }
  const int seq_len = a.seq_lens[b];
  const int n = min(P, (seq_len + a.page - 1) / a.page);  // valid pages
  const int k = min(a.K, n);
  const int64_t qbase = (static_cast<int64_t>(b) * a.Hkv + h) * G * kHeadDim;
  const int per = (n + kCluster - 1) / kCluster;
  const int lo = rank * per;
  const int nloc = max(0, min(n - lo, per));              // own pages

  // 1. Score the CTA's pages through the ring.
  const M* kmax = static_cast<const M*>(a.kmax);
  const M* kmin = static_cast<const M*>(a.kmin);
  const int nst = (nloc + SP - 1) / SP;
  auto stage_rows = [&](int t) {
    return reinterpret_cast<M*>(ring + (t % kScoreSlots) * kScoreSlotBytes);
  };
  auto issue = [&](int t) {  // thread 0: pages [t * SP, ...) of the segment
    M* dmax = stage_rows(t);
    M* dmin = dmax + SP * kHeadDim;
    uint64_t* bar = &fs.bars[t % kScoreSlots];
    const int p0 = t * SP, p1 = min(nloc, p0 + SP);
    bar_expect(bar, 2 * (p1 - p0) * ROW);
    for (int p = p0; p < p1;) {
      const int lp = lo + p, blk = lp / a.bpp, off = lp - blk * a.bpp;
      const int run = min(p1 - p, a.bpp - off);
      const int64_t src =
          (static_cast<int64_t>(h) * a.NP + tab[blk] * a.bpp + off) * kHeadDim;
      bulk_g2s(dmax + (p - p0) * kHeadDim, kmax + src, run * ROW, bar);
      bulk_g2s(dmin + (p - p0) * kHeadDim, kmin + src, run * ROW, bar);
      p += run;
    }
  };
  cluster_arrive_relaxed();  // this CTA has started (its shared memory is live)
  __syncthreads();  // the table, the barriers
  if (tid == 0)
    for (int t = 0; t < min(nst, kScoreSlots); ++t) issue(t);
  round_query<M, G>(a.q, a.q_bf16, qbase, fs.qs);
  __syncthreads();  // qs
  auto put_key = [&](int p, float s) {  // segment page p's score
    keys[lo + p] = lo + p == n - 1 ? kKeyPosInf : order_key(s);
  };
  if constexpr (sizeof(M) == 2) {
    // Tensor cores: each round's stages are cut into tiles of 16 pages,
    // one a warp.
    constexpr int TPS = SP / kScoreTile;  // tiles a stage
    QueryFrags<G> qf;
    qf.load(fs.qs);
    const int gid = lane >> 2;
    for (int t0 = 0; t0 < nst; t0 += kScoreSlots) {
      const int nr = min(kScoreSlots, nst - t0);
      for (int tile = warp; tile < nr * TPS; tile += kWarps) {
        const int t = t0 + tile / TPS;
        bar_wait(&fs.bars[t % kScoreSlots], (t / kScoreSlots) & 1);
        const M* dmax = stage_rows(t) + (tile % TPS) * kScoreTile * kHeadDim;
        float s_lo, s_hi;
        tile_scores<M, G>(smem_rows(dmax, dmax + SP * kHeadDim, kHeadDim),
                          qf, a.agg_sum != 0, s_lo, s_hi);
        const int p = t * SP + (tile % TPS) * kScoreTile + gid;
        if ((lane & 3) == 0) {
          if (p < nloc) put_key(p, s_lo);
          if (p + 8 < nloc) put_key(p + 8, s_hi);
        }
      }
      __syncthreads();  // the round's stages are read
      if (tid == 0)
        for (int t = t0; t < t0 + nr; ++t)
          if (t + kScoreSlots < nst) {
            fence_proxy_async();
            issue(t + kScoreSlots);
          }
    }
  } else {
    constexpr int E = TeamRow<M>::E;
    float lq[G][E];  // the lane's dims of the query rows, in registers
    const int c = lane % TeamRow<M>::L;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < E; ++j) lq[g][j] = fs.qs[g][c * E + j];
    }
    for (int t = 0; t < nst; ++t) {
      bar_wait(&fs.bars[t % kScoreSlots], (t / kScoreSlots) & 1);
      const M* dmax = stage_rows(t);
      score_rows<M, G>(dmax, dmax + SP * kHeadDim, &lq[0][0], E,
                       min(nloc - t * SP, SP), a.agg_sum != 0,
                       [&](int p, float s) { put_key(t * SP + p, s); });
      __syncthreads();  // the stage is read
      if (tid == 0 && t + kScoreSlots < nst) {
        fence_proxy_async();
        issue(t + kScoreSlots);
      }
    }
  }
  // The CTA's keys to every peer, at the pages' places in its key array.
  cluster_wait();  // every peer has started: its shared memory may be written
  for (int i = tid; i < (kCluster - 1) * nloc; i += blockDim.x) {
    const int j = i / nloc, p = lo + i % nloc;
    cluster.map_shared_rank(keys, j < rank ? j : j + 1)[p] = keys[p];
  }
  QT_STAMP(1);

  // 2. Select, once every CTA's keys have reached every CTA.
  cluster.sync();
  QT_STAMP(2);
  if (k > 0) {  // the same in every thread
    radix_select(keys, n, static_cast<unsigned>(k), fs.sm);
    QT_STAMP(3);
    compact_selected(keys, n, fs.sm.thr, fs.sm.ties, fs.sel, k, fs.sm);
  }
  __syncthreads();
  QT_STAMP(4);
  if (a.ids_out != nullptr && rank == 0) {
    int* ids_out = a.ids_out + (static_cast<int64_t>(b) * a.Hkv + h) * a.K;
    for (int s = tid; s < a.K; s += blockDim.x)
      ids_out[s] = s < k ? fs.sel[s] : 0;
  }

  // 3. Attention over this CTA's share of the k selected pages, warp by
  // warp.
  const int spr = (k + kCluster - 1) / kCluster;
  const int s0 = rank * spr;
  const int nsel = max(0, min(k - s0, spr));
  const int* ids = fs.sel + s0;
  const T* kv = static_cast<const T*>(a.kv);
  const int ntok = nsel * a.page;
  const int nchunk = (ntok + TC - 1) / TC;
  T* kb = reinterpret_cast<T*>(ring + warp * kWarpBytes);
  T* vb = kb + TC * STR;
  float* wa = reinterpret_cast<float*>(ring + warp * kWarpBytes);
  // Chunk c's K and V rows into the warp's buffer. A chunk lies in one
  // page (TC divides the page size), so its rows are contiguous in the
  // pool; rows past the share are zero-filled (no stale value meets a zero
  // probability in PV).
  auto load_chunk = [&](int c) {
    const int t0 = c * TC, e0 = t0 % a.page;
    const T* src = kv + kv_row(h, phys_page(tab, 0, a.NB, a.bpp,
                                            ids[t0 / a.page]),
                               e0, a.NP, a.page, kHeadDim);
    const int rows = min(TC, ntok - t0);
    for (int i = lane; i < TC * CPR; i += 32) {
      const int r = i / CPR, off = r * kHeadDim + (i % CPR) * CH;
      const bool ok = r < rows;
      cp_async16(kb + r * STR + (i % CPR) * CH, ok ? src + off : kv, ok);
      cp_async16(vb + r * STR + (i % CPR) * CH,
                 ok ? src + a.page * kHeadDim + off : kv, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
  };
  // Token e0 + r of the chunk's page is past the row's length.
  auto token_ok = [&](int c, int r) {
    const int t0 = c * TC;
    return t0 + r < ntok &&
           ids[t0 / a.page] * a.page + t0 % a.page + r < seq_len;
  };
  if constexpr (kMma) {
    // Tensor cores, m16n8k16 with the G heads as rows (padded to 16; lane
    // l holds head gid = l / 4): QK^T has K^T as B (8 tokens a tile,
    // straight from the padded rows); its C fragments, as bf16, are PV's
    // A (16 tokens a step), and V comes in through ldmatrix.trans.
    const int gid = lane >> 2, tig = lane & 3;
    uint32_t qa[8][2];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float* qr = fs.qs[gid < G ? gid : 0] + kk * 16 + 2 * tig;
      qa[kk][0] = gid < G ? pack_bf16(qr[0], qr[1]) : 0u;
      qa[kk][1] = gid < G ? pack_bf16(qr[8], qr[9]) : 0u;
    }
    float m_run = QT_MASK_VALUE, l_run = 0.f, acc[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    // ldmatrix: lane l addresses row l % 8 of matrix l / 8 (tokens +8 for
    // odd matrices, dims +8 for matrices 2 and 3).
    const T* vr =
        vb + ((lane & 7) + ((lane >> 3) & 1) * 8) * STR + (lane >> 4) * 8;
    for (int c = warp; c < nchunk; c += kWarps) {
      load_chunk(c);
      if (c == warp) QT_STAMP(5);
      float sc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const T* kr = kb + (8 * j + gid) * STR + kk * 16 + 2 * tig;
          mma_bf16(sc[j], qa[kk][0], 0u, qa[kk][1], 0u, ld_u32(kr),
                   ld_u32(kr + 8));
        }
      }
      // Online softmax of head gid over the chunk's 16 tokens (4 lanes
      // hold them); masked tokens weigh 0.
      float mx = QT_MASK_VALUE;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[j][e] = token_ok(c, 8 * j + 2 * tig + e) ? sc[j][e] * a.sm_scale
                                                      : QT_MASK_VALUE;
          mx = fmaxf(mx, sc[j][e]);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pr = sc[j][e] == QT_MASK_VALUE ? 0.f
                                                     : expf(sc[j][e] - m_new);
          sum += pr;
          sc[j][e] = pr;
        }
      }
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      const float alpha = expf(m_run - m_new);
      l_run = alpha * l_run + sum;
      m_run = m_new;
      const uint32_t a0 = pack_bf16(sc[0][0], sc[0][1]);
      const uint32_t a2 = pack_bf16(sc[1][0], sc[1][1]);
#pragma unroll
      for (int d16 = 0; d16 < 8; ++d16) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vr + d16 * 16);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          float* o = acc[2 * d16 + t];
          o[0] *= alpha;
          o[1] *= alpha;
          mma_bf16(o, a0, 0u, a2, 0u, bv[2 * t], bv[2 * t + 1]);
        }
      }
      __syncwarp();  // the buffers are read before the next loads
    }
    // The warp's partial: head gid, dims 8j + 2 tig, + 1.
    if (gid < G) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        wa[gid * kHeadDim + 8 * j + 2 * tig] = acc[j][0];
        wa[gid * kHeadDim + 8 * j + 2 * tig + 1] = acc[j][1];
      }
      if (tig == 0) {
        fs.wm[warp][gid] = m_run;
        fs.wl[warp][gid] = l_run;
      }
    }
  } else {
    // FMAs: QK a lane a token, PV a lane DL output dims.
    float m_run[G], l_run[G], acc[G][DL];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      m_run[g] = QT_MASK_VALUE;
      l_run[g] = 0.f;
#pragma unroll
      for (int j = 0; j < DL; ++j) acc[g][j] = 0.f;
    }
    for (int c = warp; c < nchunk; c += kWarps) {
      load_chunk(c);
      if (c == warp) QT_STAMP(5);
      // Scores: dot in f32 of the rounded q and K, then the softmax scale.
      const bool ok = lane < TC && token_ok(c, lane);
      const T* krow = kb + (lane < TC ? lane : TC - 1) * STR;
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
#pragma unroll 4
      for (int cc = 0; cc < CPR; ++cc) {
        float f[CH];
        Elem<T>::unpack(*reinterpret_cast<const uint4*>(krow + cc * CH), f);
        if constexpr (kRoundKV) {
#pragma unroll
          for (int j = 0; j < CH; ++j) f[j] = Elem<M>::round(f[j]);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4* qv =
              reinterpret_cast<const float4*>(&fs.qs[g][cc * CH]);
#pragma unroll
          for (int j4 = 0; j4 < CH / 4; ++j4) {
            const float4 x = qv[j4];
            s[g] = fmaf(x.x, f[4 * j4], s[g]);
            s[g] = fmaf(x.y, f[4 * j4 + 1], s[g]);
            s[g] = fmaf(x.z, f[4 * j4 + 2], s[g]);
            s[g] = fmaf(x.w, f[4 * j4 + 3], s[g]);
          }
        }
      }
      // Online softmax over the chunk, head by head; masked tokens weigh 0.
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float sc = ok ? s[g] * a.sm_scale : QT_MASK_VALUE;
        const float m_new = fmaxf(m_run[g], warp_max(sc));
        const float pr = ok ? expf(sc - m_new) : 0.f;
        const float alpha = expf(m_run[g] - m_new);
        l_run[g] = alpha * l_run[g] + warp_sum(pr);
        m_run[g] = m_new;
#pragma unroll
        for (int j = 0; j < DL; ++j) acc[g][j] *= alpha;
        if (lane < TC) fs.ps[warp][g][lane] = Elem<M>::round(pr);
      }
      __syncwarp();
      const int nr = min(TC, ntok - c * TC);
      for (int r = 0; r < nr; ++r) {
        float v[DL];
        load4(vb + r * STR + lane * DL, v);
        if constexpr (kRoundKV) {
#pragma unroll
          for (int j = 0; j < DL; ++j) v[j] = Elem<M>::round(v[j]);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pr = fs.ps[warp][g][r];
#pragma unroll
          for (int j = 0; j < DL; ++j) acc[g][j] = fmaf(pr, v[j], acc[g][j]);
        }
      }
      __syncwarp();  // the buffers and ps are read before the next loads
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int j = 0; j < DL; ++j) wa[g * kHeadDim + lane * DL + j] = acc[g][j];
      if (lane == 0) {
        fs.wm[warp][g] = m_run[g];
        fs.wl[warp][g] = l_run[g];
      }
    }
  }
  QT_STAMP(6);

  // 4. Merge the warps' partials (numerators in each warp's buffer) into
  // the CTA's, push each head's to the CTA that merges it (rank g % 8),
  // and after one cluster barrier merge the kCluster partials of the heads
  // this CTA owns from its own shared memory.
  __syncthreads();
  if (tid < G * kWarps) {  // each warp's weight for head g
    const int g = tid / kWarps, w = tid % kWarps;
    float mx = QT_MASK_VALUE;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) mx = fmaxf(mx, fs.wm[v][g]);
    fs.ww[g][w] = expf(fs.wm[w][g] - mx);
    if (w == 0) fs.m[g] = mx;
  }
  __syncthreads();
  for (int i = tid; i < G * kHeadDim; i += blockDim.x) {
    const int g = i / kHeadDim, d = i % kHeadDim;
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      den += fs.ww[g][w] * fs.wl[w][g];
      num += fs.ww[g][w] *
             reinterpret_cast<const float*>(ring + w * kWarpBytes)[i];
    }
    FusedShared<G>* dst = cluster.map_shared_rank(&fs, g % kCluster);
    dst->rpart[g / kCluster][rank][d] = num;
    if (d == 0) {
      dst->rm[g / kCluster][rank] = fs.m[g];
      dst->rl[g / kCluster][rank] = den;
    }
  }
  cluster.sync();  // every partial has reached its owner
  if (tid < kHeadDim) {
    for (int g = rank; g < G; g += kCluster) {
      const int r = g / kCluster;
      float mx = QT_MASK_VALUE;
#pragma unroll
      for (int j = 0; j < kCluster; ++j) mx = fmaxf(mx, fs.rm[r][j]);
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int j = 0; j < kCluster; ++j) {
        const float w = expf(fs.rm[r][j] - mx);
        den += w * fs.rl[r][j];
        num += w * fs.rpart[r][j][tid];
      }
      a.out[(qbase + g * kHeadDim) + tid] = den > 0.f ? num / den : 0.f;
    }
  }
  QT_STAMP(7);
  QT_STAMP_NS(9);
}

template <typename T, typename M, int G>
cudaError_t launch_fused(const FusedArgs& a, int B, cudaStream_t stream) {
  const int P = a.NB * a.bpp;
  const size_t smem =
      static_cast<size_t>(P + a.NB) * sizeof(unsigned) + 128 + kRingBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_kernel<T, M, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(kCluster * a.Hkv, B);
  fused_decode_kernel<T, M, G><<<grid, kFusedThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename M>
cudaError_t dispatch_group(const FusedArgs& a, int B, int G,
                           cudaStream_t stream) {
  switch (G) {
    case 1: return launch_fused<T, M, 1>(a, B, stream);
    case 2: return launch_fused<T, M, 2>(a, B, stream);
    case 4: return launch_fused<T, M, 4>(a, B, stream);
    case 8: return launch_fused<T, M, 8>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace qt

#ifdef QT_FUSED_STAGES
// stamps: [B * Hkv * kCluster, kStamps] int64 on the card, or null.
extern "C" int fused_decode_stamps(void* stamps) {
  return static_cast<int>(
      cudaMemcpyToSymbol(qt::g_stamps, &stamps, sizeof(stamps)));
}
#endif

extern "C" int fused_decode_launch(
    const void* q, const void* kv, const void* kmax, const void* kmin,
    const int* tab, const int* seq_lens, float* out, int* ids_out, int B,
    int Hkv, int G, int NP, int page, int NB, int bpp, int K, int kv_bf16,
    int meta_bf16, int agg_sum, int q_bf16, float sm_scale, void* stream) {
  // A 16-token chunk (8 over an f32 pool) lies in one page.
  if (K < 1 || K > qt::kMaxBudget || page % (kv_bf16 ? 16 : 8) != 0 ||
      ((reinterpret_cast<uintptr_t>(kv) | reinterpret_cast<uintptr_t>(kmax) |
        reinterpret_cast<uintptr_t>(kmin)) & 15) != 0)
    return cudaErrorInvalidValue;
  qt::FusedArgs a{q,   kv,  kmax, kmin, tab,      seq_lens, out,    ids_out,
                  Hkv, NP,  page, NB,   bpp,      K,        sm_scale,
                  agg_sum,  q_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (kv_bf16)
    err = meta_bf16 ? qt::dispatch_group<__nv_bfloat16, __nv_bfloat16>(a, B, G, s)
                    : qt::dispatch_group<__nv_bfloat16, float>(a, B, G, s);
  else
    err = meta_bf16 ? qt::dispatch_group<float, __nv_bfloat16>(a, B, G, s)
                    : qt::dispatch_group<float, float>(a, B, G, s);
  return static_cast<int>(err);
}
