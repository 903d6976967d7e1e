// Paged flash-decode attention shared by the dense and the sparse decode
// kernels: one CTA attends the G query heads of one (batch row, selection
// head) over one split of its pages (dense) or selection slots (sparse);
// the splits of a (row, head) merge by their log-sum-exp. The split takes
// the place of the TPU kernels' sequential grid axis, which carried
// m/l/acc from step to step.
//
// bf16 and fp8 pools: decode_ring, one launch a call.
// - The producer warp resolves the split's pages (slot -> logical page ->
//   physical page through the block table) into shared memory while the
//   row's length is read. Its lane j then owns ring stage j and brings
//   stages j, j + kStages, ... into it, each once the previous one there
//   has been read: a stage is 16 tokens (whole pages of up to 16 tokens,
//   or a 16-token slice of a larger page). bf16: one TMA copy a page
//   (decode_tensor_map: K and V rows of a page in one 5-D box, 128-byte
//   swizzle; copies a stage cannot fill read past the map, which TMA
//   zero-fills). fp8: one bulk copy (cp.async.bulk) a page, K and V being
//   one contiguous run of the pool. Completion is by mbarrier
//   complete_tx; every stage that fits is issued before the first is
//   read.
// - kConsumers warps take the stages in turn, each with its own online
//   softmax (attend.cuh: mma.sync m16n8k16, heads padded to 16 rows), so
//   no CTA barrier sits in the loop. bf16 stages are read where TMA put
//   them (the swizzle keeps ldmatrix and the K reads to 2-way bank
//   conflicts); fp8 stages are widened by the upcast_fp8 recipe
//   (fp8x16_to_bf16) into a padded bf16 buffer of the warp's own first.
//   Tokens are masked by position (< seq_len); rows that are not tokens
//   hold zeros.
// - The warps' partials merge in shared memory. A (row, head) with one
//   split writes its output there; otherwise each CTA writes its partial,
//   takes a ticket (atomicAdd), and the last CTA of the (row, head) merges
//   every split's partial in split order (so the result does not depend
//   on which CTA comes last) and resets the ticket to 0 for the next
//   launch.
// - The grid is sized from shapes and the SM count only (the wrapper
//   reads no device value; ops/decode_common.py:decode_plan): CTAs past
//   a row's pages or valid slots exit at once and take no ticket.
// f32 pools keep the FMA body: decode_partial, then decode_merge.
//
// Any GQA group G: a CTA takes a sub-group of at most 16 of the
// selection head's G query heads, padded to GP in {1, 2, 4, 8, 16} (the
// kernels' template). Padded rows hold a zero query, are never read
// from q and never written to out; a group of more than 16 heads runs
// nsub = ceil(G / 16) sub-groups, each a CTA row of its own that reads
// the head's pages again. Partials, (m, l) and tickets are kept a unit
// (row, selection head, sub-group) of GP heads.
//
// Numerics follow the JAX kernels: the un-scaled q (bf16 or f32) is
// multiplied by the softmax scale in f32 and rounded to the pool dtype
// (bf16 for an fp8 pool) before QK; scores and the softmax run in f32
// with the finite mask value -1e30; p is rounded the same way before the
// PV product, which accumulates in f32; the sum l uses the unrounded p.
// fp8 pages are read with the upcast_fp8 recipe (common.cuh).
#pragma once

#include <string.h>

#include "attend.cuh"
#include "tensor_map.cuh"

namespace qt {

constexpr int kD = 128;        // head dim the decode kernels take
constexpr int kThreads = 128;  // thread t owns output dim t in PV

struct DecodeArgs {
  const void* q;         // [B, Hsel*G, D] un-scaled, bf16 or f32
  const void* kv;        // one layer of the pool [Hkv, NP, 2, page, D]
  const int* tab;        // [B, NB]
  const int* seq_lens;   // [B]
  const int* indices;    // sparse: [B, Hsel, S] logical page ids
  const int* num_valid;  // sparse: [B]
  float* part_o;         // [B, Hsel*nsub, nsplit, GP, D] split partials
  float* part_ml;        // [B, Hsel*nsub, nsplit, GP, 2]
  int* tickets;          // [B, Hsel*nsub], zero between launches (decode_ring)
  float* out;            // [B, Hsel*G, D]
  int Hsel, kvdiv, NP, page, NB, bpp, S, nsplit, per_split;
  float sm_scale;
  int q_bf16;            // q dtype: 1 = bf16, 0 = f32
  int G, nsub;           // query heads a selection head; its sub-groups
  int window;            // dense: > 0 attends only the last `window` keys
};

// Where a CTA's sub-group lies: blockIdx.y = hsel * nsub + sub.
struct DecodeUnit {
  int hsel, g0, ng;      // selection head, first head, real heads
  int64_t unit, qrow0;   // unit index (partials, tickets); q/out row
  template <int GP>
  __device__ __forceinline__ static DecodeUnit of(const DecodeArgs& a,
                                                  int b) {
    DecodeUnit u;
    u.hsel = blockIdx.y / a.nsub;
    u.g0 = (blockIdx.y % a.nsub) * GP;
    u.ng = min(GP, a.G - u.g0);
    u.unit = static_cast<int64_t>(b) * a.Hsel * a.nsub + blockIdx.y;
    u.qrow0 = (static_cast<int64_t>(b) * a.Hsel + u.hsel) * a.G + u.g0;
    return u;
  }
};

// Dense: the first logical page a row attends (that of its first key
// inside the window; 0 without one). Item i of a dense row is page
// first_page + i.
template <bool kSparse>
__device__ __forceinline__ int first_page(const DecodeArgs& a, int b) {
  return kSparse || a.window <= 0
             ? 0 : max(0, a.seq_lens[b] - a.window) / a.page;
}

// The first key position a row attends (dense, inside its window).
template <bool kSparse>
__device__ __forceinline__ int first_key(const DecodeArgs& a, int b) {
  return kSparse || a.window <= 0 ? 0 : a.seq_lens[b] - a.window;
}

// Pages (dense, from first_page) or valid selection slots (sparse) of
// batch row b.
template <bool kSparse>
__device__ __forceinline__ int decode_items(const DecodeArgs& a, int b) {
  return kSparse ? max(0, min(a.num_valid[b], a.S))
                 : min((a.seq_lens[b] + a.page - 1) / a.page, a.NB * a.bpp) -
                       first_page<kSparse>(a, b);
}

// f32 pools. One CTA = (split, selection head, batch row). A split covers
// ``per_split`` consecutive pages (dense) or selection slots (sparse).
template <typename T, int G, bool kSparse>
__global__ void __launch_bounds__(kThreads)
decode_partial(DecodeArgs a) {  // G: the padded sub-group GP
  using S = typename TileElem<T>::type;              // tile element
  constexpr int GCH = Elem<T>::kPerChunk;            // pool elements per 16 B
  constexpr int GCPR = kD / GCH;                     // pool chunks per row
  constexpr int CH = Elem<S>::kPerChunk;             // tile elements per 16 B
  constexpr int CPR = kD / CH;                       // tile chunks per row
  constexpr int TT = sizeof(S) == 2 ? 64 : 32;       // tokens per tile
  constexpr int KSTR = kD + CH;                      // padded K row

  __shared__ __align__(16) S ks[TT * KSTR];
  __shared__ __align__(16) S vs[TT * kD];
  __shared__ float qs[G][kD];
  __shared__ float ps[G][TT];
  __shared__ float m_s[G], l_s[G], alpha_s[G];
  __shared__ int64_t rowoff[TT];
  __shared__ int valid_s[TT];

  const int split = blockIdx.x, b = blockIdx.z;
  const DecodeUnit u = DecodeUnit::of<G>(a, b);
  const int hsel = u.hsel;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* kv = static_cast<const T*>(a.kv);
  const int page = a.page;
  const int seq_len = a.seq_lens[b];
  const int h_kv = hsel / a.kvdiv;
  const int n_items = decode_items<kSparse>(a, b);
  const int lp0 = first_page<kSparse>(a, b), lo = first_key<kSparse>(a, b);
  const int first = split * a.per_split;
  const int ntok = max(0, min(first + a.per_split, n_items) - first) * page;

  const int64_t qbase = u.qrow0 * kD;
  for (int i = tid; i < G * kD; i += kThreads) {
    float x = 0.f;  // padded heads: a zero query
    if (i / kD < u.ng)
      x = a.q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(a.q)[qbase + i])
                   : static_cast<const float*>(a.q)[qbase + i];
    qs[i / kD][i % kD] = Elem<S>::round(x * a.sm_scale);
  }
  if (tid < G) {
    m_s[tid] = QT_MASK_VALUE;
    l_s[tid] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < ntok; t0 += TT) {
    // Where each token of the tile lives, and whether it is real.
    if (tid < TT) {
      const int t = t0 + tid;
      int64_t off = -1;
      int valid = 0;
      if (t < ntok) {
        const int item = first + t / page, e = t % page;
        const int lp = kSparse
            ? a.indices[(static_cast<int64_t>(b) * a.Hsel + hsel) * a.S + item]
            : lp0 + item;
        off = kv_row(h_kv, phys_page(a.tab, b, a.NB, a.bpp, lp), e, a.NP,
                     page, kD);
        valid = lp * page + e < seq_len && lp * page + e >= lo;
      }
      rowoff[tid] = off;
      valid_s[tid] = valid;
    }
    __syncthreads();

    // K and V rows, 16 bytes of the pool a thread; rows past the split
    // read zeros.
    for (int c = tid; c < TT * GCPR; c += kThreads) {
      const int r = c / GCPR, cc = c % GCPR;
      const int64_t off = rowoff[r];
      uint4 kk = make_uint4(0, 0, 0, 0), vv = kk;
      if (off >= 0) {
        kk = __ldg(reinterpret_cast<const uint4*>(kv + off) + cc);
        vv = __ldg(reinterpret_cast<const uint4*>(kv + off + page * kD) + cc);
      }
      store_tile_chunk<T>(&ks[r * KSTR + cc * GCH], kk);
      store_tile_chunk<T>(&vs[r * kD + cc * GCH], vv);
    }
    __syncthreads();

    // Scores: one (head, token) pair per thread and step.
    for (int i = tid; i < G * TT; i += kThreads) {
      const int g = i / TT, r = i % TT;
      const S* krow = &ks[r * KSTR];
      float s = 0.f;
#pragma unroll 4
      for (int c = 0; c < CPR; ++c) {
        float f[CH];
        Elem<S>::unpack(*reinterpret_cast<const uint4*>(krow + c * CH), f);
#pragma unroll
        for (int j = 0; j < CH; ++j) s = fmaf(qs[g][c * CH + j], f[j], s);
      }
      ps[g][r] = valid_s[r] ? s : QT_MASK_VALUE;
    }
    __syncthreads();

    // Online softmax, one warp per head.
    for (int g = warp; g < G; g += kThreads / 32) {
      const float m_prev = m_s[g];
      float mx = QT_MASK_VALUE;
      for (int r = lane; r < TT; r += 32) mx = fmaxf(mx, ps[g][r]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < TT; r += 32) {
        const float p = valid_s[r] ? expf(ps[g][r] - m_new) : 0.f;
        sum += p;
        ps[g][r] = Elem<S>::round(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV: thread tid owns output dim tid for every head.
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= alpha_s[g];
    for (int r = 0; r < TT; ++r) {
      const float v = Elem<S>::to_float(vs[r * kD + tid]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(ps[g][r], v, acc[g]);
    }
    __syncthreads();
  }

  const int64_t part = u.unit * a.nsplit + split;
#pragma unroll
  for (int g = 0; g < G; ++g) a.part_o[(part * G + g) * kD + tid] = acc[g];
  if (tid < G) {
    a.part_ml[(part * G + tid) * 2] = m_s[tid];
    a.part_ml[(part * G + tid) * 2 + 1] = l_s[tid];
  }
}

// All-reduce of one value over the CTA (max or sum), through `red`.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w)
    v = kMax ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();
  return v;
}

// Merge the splits of one query head: grid (GP, Hsel * nsub, B), dynamic
// shared memory of nsplit floats; padded heads exit. The threads share
// out the splits to find the largest m and each split's weight
// exp(m_j - M); then thread d sums the weighted partials of output dim
// d. Empty splits carry m = -1e30, l = 0 and weigh nothing.
template <int G>
__global__ void __launch_bounds__(kThreads)
decode_merge(const DecodeArgs a) {
  extern __shared__ float w_s[];
  __shared__ float red[kThreads / 32];
  const int g = blockIdx.x, b = blockIdx.z;
  const DecodeUnit u = DecodeUnit::of<G>(a, b);
  if (g >= u.ng) return;  // a padded head (the same in the whole CTA)
  const float* part_o = a.part_o;
  const float* part_ml = a.part_ml;
  const int nsplit = a.nsplit;
  const int tid = threadIdx.x;
  const int64_t base = u.unit * nsplit;
  float mx = QT_MASK_VALUE;
  for (int j = tid; j < nsplit; j += kThreads)
    mx = fmaxf(mx, part_ml[((base + j) * G + g) * 2]);
  const float M = block_reduce<true>(mx, red);
  float den = 0.f;
  for (int j = tid; j < nsplit; j += kThreads) {
    const float w = expf(part_ml[((base + j) * G + g) * 2] - M);
    w_s[j] = w;
    den += w * part_ml[((base + j) * G + g) * 2 + 1];
  }
  den = block_reduce<false>(den, red);     // also publishes w_s
  float num = 0.f;
#pragma unroll 4
  for (int j = 0; j < nsplit; ++j)
    num += w_s[j] * part_o[((base + j) * G + g) * kD + tid];
  a.out[(u.qrow0 + g) * kD + tid] = den > 0.f ? num / den : 0.f;
}

// ---------------------------------------------------------------------------
// bf16 and fp8 pools: decode_ring.
// ---------------------------------------------------------------------------

constexpr int kConsumers = 4;                       // consumer warps
constexpr int kRingThreads = (kConsumers + 1) * 32;  // + the producer warp
constexpr int kPrivStr = kD + 8;  // padded bf16 row of a warp's buffer
constexpr int kPrivBytes = 2 * kChunk * kPrivStr * 2;  // K and V, 16 rows
constexpr int kSlotBytes = 8 << 10;                    // a ring stage

// The ring of a pool dtype T: stages of 16 tokens' K and V rows (8 KB in
// bf16: up to 16 tokens of whole pages, one TMA copy a page at 1024-byte
// aligned places; 4 KB of fp8: whole pages back to back, one bulk copy a
// page), 64 KB either way; and the warps' buffers: each warp's padded
// bf16 chunk (fp8, which is widened there) or its partial (bf16).
template <typename T, int GP = 8>
struct Ring {
  static constexpr bool kTma = sizeof(T) == 2;
  static constexpr int kRowBytes = kD * sizeof(T);
  static constexpr int kSlot = kTma ? kSlotBytes : kSlotBytes / 2;
  static constexpr int kStages = kTma ? 8 : 16;
  static constexpr int kBytes = kStages * kSlot;
  static constexpr int kWarpBytes =
      kTma ? (GP > 8 ? GP : 8) * kD * 4 : kPrivBytes;
  static_assert(kWarpBytes >= GP * kD * 4, "a warp's partial fits");
};

// Dynamic shared memory of decode_ring: 1024 bytes of alignment, the
// ring, the warps' buffers, the split's logical and physical pages.
template <typename R>
__host__ __device__ constexpr size_t ring_smem(int per_split) {
  return 1024 + R::kBytes + kConsumers * R::kWarpBytes +
         2 * static_cast<size_t>(per_split) * sizeof(int);
}

// How a split's pages fill the stages of ring R. A copy brings pg = min(
// page, 16) token rows of one page, K then V (ops bytes apart in a stage):
// a stage holds tokens [0, spg * pg) of spg items of the split (pages of
// up to 16 tokens), or 16 tokens of one item from e0 on (spp stages a
// page of more than 16). Token r of a stage is token e0 + r % pg of its
// (r / pg)-th item; its K row lies (r / pg) * ops + (r % pg) * row bytes
// into the stage, its V row pg rows further.
template <typename R>
struct StageMap {
  int page, pg, ops, spg, spp, nit;
  __device__ __forceinline__ StageMap(int page_, int nit_)
      : page(page_), pg(min(page_, kChunk)),
        ops(R::kTma ? (pg * 2 * R::kRowBytes + 1023) & ~1023
                    : pg * 2 * R::kRowBytes),
        spg(page_ <= kChunk ? min(kChunk / page_, R::kSlot / ops) : 1),
        spp(page_ <= kChunk ? 1 : (page_ + kChunk - 1) / kChunk), nit(nit_) {}
  __device__ __forceinline__ int stages() const {
    return page <= kChunk ? (nit + spg - 1) / spg : nit * spp;
  }
  // Byte offset of token r's K row in a stage (r < spg * pg).
  __device__ __forceinline__ int krow(int r) const {
    return pg == kChunk ? r * R::kRowBytes
                        : (r / pg) * ops + (r % pg) * R::kRowBytes;
  }
};

static_assert(Ring<__nv_bfloat16>::kStages <= 32 &&
                  Ring<__nv_fp8_e4m3>::kStages <= 32,
              "a producer lane a ring slot");

// One 5-D TMA box (decode_tensor_map: 64 columns x 2 halves x pg rows x
// K/V x 1 page) at coordinates (0, 0, e0, 0, p) into shared memory,
// completing on bar.
__device__ __forceinline__ void tma_page(void* dst, const CUtensorMap* map,
                                         int e0, int p, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %2, %3, %2, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(e0), "r"(p),
      "r"(smem_u32(bar))
      : "memory");
}

template <typename T, int G, bool kSparse>
__global__ void __launch_bounds__(kRingThreads, 2)
decode_ring(const DecodeArgs a, const __grid_constant__ CUtensorMap tmap) {
  // G: the padded sub-group GP.
  using bf16 = __nv_bfloat16;
  using R = Ring<T, G>;
  constexpr int GCH = Elem<T>::kPerChunk;  // pool elements per 16 B
  constexpr int GCPR = kD / GCH;           // 16-byte pieces of a pool row
  constexpr int kStages = R::kStages;

  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ __align__(16) float qs[G][kD];  // q scaled, rounded to bf16
  __shared__ float wm[kConsumers][G], wl[kConsumers][G];
  __shared__ float ww[G][kConsumers], mg[G];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ __align__(256) unsigned char zero_row[256];  // rows a stage
                                                          // cannot hold
  __shared__ int is_last;

  const int split = blockIdx.x, b = blockIdx.z;
  const DecodeUnit u = DecodeUnit::of<G>(a, b);
  const int hsel = u.hsel;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int page = a.page;
  const int first = split * a.per_split;
  const int64_t grp = static_cast<int64_t>(b) * a.Hsel + hsel;
  unsigned char* ring = dyn + ((1024 - (smem_u32(dyn) & 1023)) & 1023);
  unsigned char* wbuf = ring + R::kBytes;  // the warps' buffers
  int* it_lp = reinterpret_cast<int*>(wbuf + kConsumers * R::kWarpBytes);
  int* it_pg = it_lp + a.per_split;  // h_kv * NP + physical page
  const int n_items = decode_items<kSparse>(a, b);
  const int lp0 = first_page<kSparse>(a, b);
  if (warp == kConsumers) {
    // The producer warp resolves the split's pages while the row's length
    // is on its way (sparse: every slot of the split, junk slots being in
    // range; dense: the table's pages).
    const int h_kv = hsel / a.kvdiv;
    const int cap = kSparse ? a.S : a.NB * a.bpp;
    for (int i = lane; i < min(cap - lp0 - first, a.per_split); i += 32) {
      const int lp =
          kSparse ? a.indices[grp * a.S + first + i] : lp0 + first + i;
      it_lp[i] = lp;
      it_pg[i] = h_kv * a.NP + phys_page(a.tab, b, a.NB, a.bpp, lp);
    }
  }
  // Split 0 always runs (a row with nothing to attend writes zeros).
  const int active = max(1, (n_items + a.per_split - 1) / a.per_split);
  if (split >= active) return;
  const int seq_len = a.seq_lens[b], lo = first_key<kSparse>(a, b);
  const StageMap<R> sm(page, max(0, min(n_items - first, a.per_split)));
  const int nst = sm.stages();

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 1);
    }
    fence_barrier_init();
  }
  if constexpr (R::kTma) {
    for (int i = tid; i < 256 / 16; i += kRingThreads)
      reinterpret_cast<uint4*>(zero_row)[i] = make_uint4(0, 0, 0, 0);
  }
  for (int i = tid; i < G * kD; i += kRingThreads) {
    const int64_t at = u.qrow0 * kD + i;
    float x = 0.f;  // padded heads: a zero query
    if (i / kD < u.ng)
      x = a.q_bf16 ? __bfloat162float(static_cast<const bf16*>(a.q)[at])
                   : static_cast<const float*>(a.q)[at];
    qs[i / kD][i % kD] = Elem<bf16>::round(x * a.sm_scale);
  }
  __syncthreads();

  // Stage s holds items from i0 (pages of up to 16 tokens) or tokens e0..
  // of item i0; a consumer steps (i0, e0) from its stage to its next.
  auto step = [&](int& i0, int& e0, int n) {
    if (page <= kChunk) {
      i0 += n * sm.spg;
    } else {
      e0 += n * kChunk;
      while (e0 >= page) {
        e0 -= sm.spp * kChunk;
        ++i0;
      }
    }
  };
  if (warp == kConsumers) {
    // The producer: lane j < kStages owns ring slot j and brings stages j,
    // j + kStages, ... into it, each once its previous stage has been
    // read, so the lanes' waits and copies overlap.
    const T* kv = static_cast<const T*>(a.kv);
    const int past = a.Hsel / a.kvdiv * a.NP;  // a page past the map
    for (int s = lane; lane < kStages && s < nst; s += kStages) {
      const int slot = lane;
      if (s >= kStages) bar_wait(&empty[slot], ((s / kStages) - 1) & 1);
      unsigned char* dst = ring + slot * R::kSlot;
      const int i0 = page <= kChunk ? s * sm.spg : s / sm.spp;
      const int e0 = page <= kChunk ? 0 : (s - i0 * sm.spp) * kChunk;
      const int ni = min(sm.spg, sm.nit - i0);
#ifdef QT_DECODE_NO_COPY
      if (true) {  // ablation (exp/decode_ablation.py): signal, no copy
        bar_arrive(&full[slot]);
        continue;
      }
#endif
      if constexpr (R::kTma) {
        // Every copy of the stage is made: copies past the split's pages
        // read past the map, which TMA fills with zeros (as rows past a
        // page of more than 16 tokens), so the products never meet a
        // stale value.
        const int nc = page <= kChunk ? sm.spg : 1;
        bar_expect(&full[slot], nc * sm.pg * 2 * R::kRowBytes);
        for (int k = 0; k < nc; ++k)
          tma_page(dst + k * sm.ops, &tmap, e0,
                   k < ni ? it_pg[i0 + k] : past, &full[slot]);
      } else if (page <= kChunk) {
        const uint32_t bytes = 2 * page * R::kRowBytes;
        bar_expect(&full[slot], ni * bytes);
        for (int k = 0; k < ni; ++k)
          bulk_g2s(dst + k * bytes,
                   kv + static_cast<int64_t>(it_pg[i0 + k]) * 2 * page * kD,
                   bytes, &full[slot]);
      } else {
        const uint32_t bytes = min(kChunk, page - e0) * R::kRowBytes;
        const T* src = kv + static_cast<int64_t>(it_pg[i0]) * 2 * page * kD;
        bar_expect(&full[slot], 2 * bytes);
        bulk_g2s(dst, src + e0 * kD, bytes, &full[slot]);
        bulk_g2s(dst + kChunk * R::kRowBytes, src + (page + e0) * kD, bytes,
                 &full[slot]);
      }
    }
    __syncwarp();
  } else {  // consumer warps: stages warp, warp + kConsumers, ...
    unsigned char* wb = wbuf + warp * R::kWarpBytes;
    const int gid = lane >> 2;
    WarpAttn<(G > 8)> att;
    att.init(gid < G ? qs[gid] : nullptr, G > 8 ? qs[(gid + 8) % G] : nullptr);
    // The lane's token of a stage (lane < 16) and its rows' offsets in a
    // stage, the same in every stage.
    const int lq = lane / sm.pg, lr = lane % sm.pg;
    const int held = page <= kChunk ? sm.spg * sm.pg : kChunk;
    int krow[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      krow[j] = 8 * j + gid < held ? sm.krow(8 * j + gid) : -1;
    const int rv = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int vrow = rv < held ? sm.krow(rv) + sm.pg * R::kRowBytes : -1;
    // fp8: the lane's rows of a stage in the widening (16-byte pieces
    // c of rows r0 + k * RPI), as pool-row indices.
    constexpr int RPI = 32 / GCPR, NPL = kChunk / RPI;
    const int r0 = lane / GCPR, c = lane % GCPR;
    int srow[NPL];
#pragma unroll
    for (int k = 0; k < NPL; ++k)
      srow[k] = sm.krow(r0 + k * RPI) / R::kRowBytes;
    int i0 = 0, e0 = 0;
    step(i0, e0, warp);
    for (int s = warp; s < nst; s += kConsumers, step(i0, e0, kConsumers)) {
      const int slot = s % kStages;
      bar_wait(&full[slot], (s / kStages) & 1);
      const unsigned char* src = ring + slot * R::kSlot;
      const int rows = page <= kChunk ? min(sm.spg, sm.nit - i0) * page
                                      : min(kChunk, page - e0);
      const bool ok =
          lane < rows && it_lp[i0 + lq] * page + e0 + lr < seq_len &&
          it_lp[i0 + lq] * page + e0 + lr >= lo;
      const unsigned valid = __ballot_sync(0xffffffffu, ok);
      if constexpr (R::kTma) {
        // The products read the stage where TMA put it; the token rows a
        // stage cannot hold (pages that do not divide 16) read zeros.
        SwizzledRows sw;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          sw.krow[j] = krow[j] >= 0 ? src + krow[j] : zero_row;
        sw.vrow = vrow >= 0 ? src + vrow : zero_row;
#ifndef QT_DECODE_NO_MMA  // ablation (exp/decode_ablation.py)
        att.chunk(sw, 1.f, valid);
#endif
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[slot]);  // the stage may be refilled
      } else {
        // Widen the stage's rows into the warp's padded bf16 buffer (rows
        // past the stage's tokens are zeros), release the stage, attend.
        bf16* kb = reinterpret_cast<bf16*>(wb);
        bf16* vb = kb + kChunk * kPrivStr;
        const T* st = reinterpret_cast<const T*>(src);
#pragma unroll
        for (int k = 0; k < NPL; ++k) {
          const int r = r0 + k * RPI;
          uint4 kk = make_uint4(0, 0, 0, 0), vv = kk;
          if (r < rows) {
            kk = *reinterpret_cast<const uint4*>(st + srow[k] * kD + c * GCH);
            vv = *reinterpret_cast<const uint4*>(st + (srow[k] + sm.pg) * kD +
                                                  c * GCH);
          }
          store_tile_chunk<T>(kb + r * kPrivStr + c * GCH, kk);
          store_tile_chunk<T>(vb + r * kPrivStr + c * GCH, vv);
        }
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[slot]);  // the stage may be refilled
#ifndef QT_DECODE_NO_MMA  // ablation (exp/decode_ablation.py)
        att.chunk(PaddedRows<kPrivStr>{kb, vb}, 1.f, valid);
#endif
        __syncwarp();  // the buffers are read before the next stage's copy
      }
    }
    att.store<G>(reinterpret_cast<float*>(wb), wm[warp], wl[warp]);
  }

  // The warps' partials (numerators in each warp's buffer) into the CTA's.
  __syncthreads();
  if (tid < G * kConsumers) {
    const int g = tid / kConsumers, w = tid % kConsumers;
    float mx = QT_MASK_VALUE;
#pragma unroll
    for (int v = 0; v < kConsumers; ++v) mx = fmaxf(mx, wm[v][g]);
    ww[g][w] = expf(wm[w][g] - mx);
    if (w == 0) mg[g] = mx;
  }
  __syncthreads();
  float* out = a.out + u.qrow0 * kD;
  float* po = a.part_o + (u.unit * a.nsplit + split) * G * kD;
  float* pml = a.part_ml + (u.unit * a.nsplit + split) * G * 2;
  for (int i = tid; i < G * kD; i += kRingThreads) {
    const int g = i / kD;
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kConsumers; ++w) {
      den += ww[g][w] * wl[w][g];
      num += ww[g][w] *
             reinterpret_cast<const float*>(wbuf + w * R::kWarpBytes)[i];
    }
    if (active == 1) {
      if (g < u.ng) out[i] = den > 0.f ? num / den : 0.f;
    } else {
      po[i] = num;
      if (i % kD == 0) {
        pml[2 * g] = mg[g];
        pml[2 * g + 1] = den;
      }
    }
  }
  if (active == 1) return;

  // The split merge: the last CTA of the (row, head) to take a ticket
  // merges every split's partial.
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // the CTA's partial (ordered by the barrier) first
    is_last = atomicAdd(&a.tickets[u.unit], 1) == active - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (tid == 0) a.tickets[u.unit] = 0;  // zero for the next launch
  // Thread t merges 4 dims of one head, a batch of kBatch splits at a time
  // (their loads issued together), with a running maximum; the splits
  // are taken in order, so the sum does not depend on the ticket order.
  constexpr int kBatch = 8;
  const float* po0 = a.part_o + u.unit * a.nsplit * G * kD;
  const float* pml0 = a.part_ml + u.unit * a.nsplit * G * 2;
  for (int i = tid; i < u.ng * kD / 4; i += kRingThreads) {
    const int g = i / (kD / 4), d4 = i % (kD / 4);
    float mx = QT_MASK_VALUE, den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < active; j0 += kBatch) {
      float4 o[kBatch];
      float2 ml[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = min(j0 + u, active - 1);
        o[u] = __ldcg(reinterpret_cast<const float4*>(po0 + (j * G + g) * kD) + d4);
        ml[u] = __ldcg(reinterpret_cast<const float2*>(pml0) + j * G + g);
      }
      float bm = mx;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (j0 + u < active) bm = fmaxf(bm, ml[u].x);
      const float c = expf(mx - bm);
      den *= c;
      num.x *= c;
      num.y *= c;
      num.z *= c;
      num.w *= c;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (j0 + u >= active) break;
        const float w = expf(ml[u].x - bm);
        den += w * ml[u].y;
        num.x += w * o[u].x;
        num.y += w * o[u].y;
        num.z += w * o[u].z;
        num.w += w * o[u].w;
      }
      mx = bm;
    }
    reinterpret_cast<float4*>(out + g * kD)[d4] =
        den > 0.f ? make_float4(num.x / den, num.y / den, num.z / den,
                                num.w / den)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T, int G, bool kSparse>
cudaError_t launch_decode(const DecodeArgs& a, const void* tmap, int B,
                          cudaStream_t stream) {
  dim3 grid(a.nsplit, a.Hsel * a.nsub, B);
  if constexpr (sizeof(T) == 4) {
    decode_partial<T, G, kSparse><<<grid, kThreads, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_merge<G><<<dim3(G, a.Hsel * a.nsub, B), kThreads,
                       a.nsplit * sizeof(float), stream>>>(a);
    return cudaGetLastError();
  } else {
    using R = Ring<T, G>;
    if (a.tickets == nullptr || (R::kTma && tmap == nullptr))
      return cudaErrorInvalidValue;
    CUtensorMap map;  // by value into the kernel's parameters
    memset(&map, 0, sizeof(map));
    if (R::kTma) memcpy(&map, tmap, sizeof(map));
    const size_t smem = ring_smem<R>(a.per_split);
    cudaError_t err = cudaFuncSetAttribute(
        decode_ring<T, G, kSparse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    decode_ring<T, G, kSparse><<<grid, kRingThreads, smem, stream>>>(a, map);
    return cudaGetLastError();
  }
}

// Dispatch on the pool dtype code (common.cuh with_elem) and the padded
// sub-group GP of a.G (a.nsub = ceil(a.G / GP) sub-groups).
template <bool kSparse>
int dispatch_decode(const DecodeArgs& a, const void* tmap, int B,
                    int kv_dtype, void* stream) {
  const int G = padded_group(a.G);
  if (a.G < 1 || a.nsub != sub_groups(a.G))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define QT_CASE(GG)                                               \
  case GG:                                                        \
    err = with_elem(kv_dtype, [&](auto t) {                       \
      return launch_decode<decltype(t), GG, kSparse>(a, tmap, B, s); \
    });                                                           \
    break;
  switch (G) {
    QT_CASE(1)
    QT_CASE(2)
    QT_CASE(4)
    QT_CASE(8)
    QT_CASE(16)
    default:
      break;
  }
#undef QT_CASE
  return static_cast<int>(err);
}

}  // namespace qt

// The TMA descriptor decode_ring reads a layer of a bf16 pool [Hkv, NP,
// 2, page, 128] through: 5-D (64 columns, 2 halves of a row, page rows,
// K/V, Hkv * NP pages), boxes of one page's first min(page, 16) rows of K
// and of V (a box at row e0 for a larger page), the 128-byte swizzle.
// Writes the 128-byte CUtensorMap to `out`; returns the CUresult, or -1
// when cuTensorMapEncodeTiled cannot be found.
extern "C" int decode_tensor_map(void* base, long long pages, int page,
                                 void* out) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return -1;
  const cuuint64_t row = 2 * qt::kD;  // bytes
  const cuuint64_t dims[5] = {64, 2, static_cast<cuuint64_t>(page), 2,
                              static_cast<cuuint64_t>(pages)};
  const cuuint64_t strides[4] = {128, row, page * row, 2 * page * row};
  const cuuint32_t box[5] = {64, 2,
                             static_cast<cuuint32_t>(page < qt::kChunk
                                                         ? page
                                                         : qt::kChunk),
                             2, 1};
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, base, dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) memcpy(out, &map, sizeof(map));
  return static_cast<int>(r);
}

