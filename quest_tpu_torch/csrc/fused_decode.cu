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
// Design: one cluster of kCluster CTAs per (batch row, KV head).
//   1. Each CTA scores 1/kCluster of the row's num_pages metadata pages
//      (the estimate's device code, select_common.cuh) into its shared
//      memory as order-preserving keys; the last page's key is +inf.
//   2. After a cluster barrier every CTA pulls all keys from its peers'
//      shared memory (distributed shared memory) and runs the exact radix
//      select and the page-order compaction itself: all CTAs hold the
//      same ascending ids, with no second barrier.
//   3. Each CTA attends the G query heads over its 1/kCluster of the
//      min(K, num_pages) selected pages, with an online softmax.
//   4. After a second cluster barrier, CTA g merges query head g's
//      partials from the peers' shared memory by log-sum-exp and writes
//      it; a last barrier keeps every CTA's shared memory alive until
//      the peers have read it.
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
// SMs (128 SMs at B=2, where one CTA a head would use 16); the select is
// a serial chain of CTA barriers that the design does not hide.
#include <cooperative_groups.h>

#include "select_common.cuh"

namespace cg = cooperative_groups;

namespace qt {

constexpr int kCluster = 8;       // CTAs a (batch row, KV head)
constexpr int kMaxBudget = 256;   // selection slots (the model's gate)

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

// Attention buffers of one CTA; after the loop, ks holds the partial
// accumulators [G, D] that the peers read.
template <typename T, int G>
struct AttnShared {
  static constexpr int CH = Elem<T>::kPerChunk;
  static constexpr int TT = sizeof(T) == 2 ? 64 : 32;  // tokens a tile
  static constexpr int KSTR = kHeadDim + CH;            // padded K row
  __align__(16) T ks[TT * KSTR];
  __align__(16) T vs[TT * kHeadDim];
  float qs[G][kHeadDim];
  float ps[G][TT];
  float m[G], l[G], alpha[G];
  int64_t rowoff[TT];
  int valid[TT];
  int ids[kMaxBudget];
};

// T: pool dtype; M: metadata dtype, also the dtype QK and PV run in.
template <typename T, typename M, int G>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kSelThreads)
fused_decode_kernel(FusedArgs a) {
  using A = AttnShared<T, G>;
  constexpr int CH = A::CH, CPR = kHeadDim / CH, TT = A::TT, KSTR = A::KSTR;
  // Pool values are rounded to M only where M is narrower (f32 pool, bf16
  // metadata); bf16 -> f32 is exact.
  constexpr bool kRoundKV = sizeof(T) > sizeof(M);
  constexpr int U = G >= 8 ? 2 : 8;
  constexpr int NCH = TT * CPR / kSelThreads;  // 16-byte chunks a thread

  // keys [P], seg [ceil(P / kCluster)], the row's block table [NB]
  extern __shared__ unsigned dyn[];
  __shared__ A at;
  __shared__ SelectShared sm;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.x / kCluster, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = a.NB * a.bpp;
  unsigned* keys = dyn;
  unsigned* seg = dyn + P;
  int* tab = reinterpret_cast<int*>(seg + (P + kCluster - 1) / kCluster);
  for (int i = tid; i < a.NB; i += blockDim.x) tab[i] = a.tab[b * a.NB + i];
  __syncthreads();
  const int seq_len = a.seq_lens[b];
  const int n = min(P, (seq_len + a.page - 1) / a.page);  // valid pages
  const int k = min(a.K, n);
  const int64_t qbase = (static_cast<int64_t>(b) * a.Hkv + h) * G * kHeadDim;

  // 1. Score this CTA's share of the valid pages.
  const int per = (n + kCluster - 1) / kCluster;
  {
    const M* kmax = static_cast<const M*>(a.kmax);
    const M* kmin = static_cast<const M*>(a.kmin);
    SplitQuery<M, G> sq;
    sq.load(a.q, a.q_bf16, qbase, lane % SplitQuery<M, G>::kLanes);
    const int lo = rank * per, hi = min(n, lo + per);
    const int64_t hrow = static_cast<int64_t>(h) * a.NP;
    score_pages<M, G, U>(
        kmax, kmin, sq, lo, hi, a.agg_sum != 0,
        [&](int p) {
          return (hrow + phys_page(tab, 0, a.NB, a.bpp, p)) * kHeadDim;
        },
        [&](int p, float s) {
          seg[p - lo] = p == n - 1 ? kKeyPosInf : order_key(s);
        });
  }
  cluster.sync();

  // 2. Every CTA gathers all keys and selects.
  for (int p = tid; p < n; p += blockDim.x) {
    const int j = p / per;
    keys[p] = cluster.map_shared_rank(seg, j)[p - j * per];
  }
  __syncthreads();
  if (k > 0) {
    radix_select(keys, n, static_cast<unsigned>(k), sm);
    compact_selected(keys, n, sm.thr, sm.ties, at.ids, a.K, sm);
  }
  __syncthreads();
  if (rank == 0 && a.ids_out != nullptr) {
    int* o = a.ids_out + (static_cast<int64_t>(b) * a.Hkv + h) * a.K;
    for (int s = tid; s < a.K; s += blockDim.x) o[s] = s < k ? at.ids[s] : 0;
  }

  // 3. Attention over this CTA's share of the k selected pages.
  const int spr = (k + kCluster - 1) / kCluster;
  const int s0 = rank * spr;
  const int ntok = max(0, min(k, s0 + spr) - s0) * a.page;
  for (int i = tid; i < G * kHeadDim; i += blockDim.x) {
    const float x =
        a.q_bf16
            ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qbase + i])
            : static_cast<const float*>(a.q)[qbase + i];
    at.qs[i / kHeadDim][i % kHeadDim] = Elem<M>::round(x);
  }
  if (tid < G) {
    at.m[tid] = QT_MASK_VALUE;
    at.l[tid] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  const T* kv = static_cast<const T*>(a.kv);
  __syncthreads();

  for (int t0 = 0; t0 < ntok; t0 += TT) {
    if (tid < TT) {
      const int t = t0 + tid;
      int64_t off = -1;
      int valid = 0;
      if (t < ntok) {
        const int lp = at.ids[s0 + t / a.page], e = t % a.page;
        off = kv_row(h, phys_page(tab, 0, a.NB, a.bpp, lp), e, a.NP, a.page,
                     kHeadDim);
        valid = lp * a.page + e < seq_len;
      }
      at.rowoff[tid] = off;
      at.valid[tid] = valid;
    }
    __syncthreads();

    // The tile's K and V rows, 16 bytes a load, all of a thread's loads
    // issued before the first store.
    uint4 kk[NCH], vv[NCH];
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = tid + i * kSelThreads, r = c / CPR, cc = c % CPR;
      const int64_t off = at.rowoff[r];
      kk[i] = vv[i] = make_uint4(0, 0, 0, 0);
      if (off >= 0) {
        kk[i] = __ldg(reinterpret_cast<const uint4*>(kv + off) + cc);
        vv[i] = __ldg(
            reinterpret_cast<const uint4*>(kv + off + a.page * kHeadDim) + cc);
      }
    }
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = tid + i * kSelThreads, r = c / CPR, cc = c % CPR;
      *reinterpret_cast<uint4*>(&at.ks[r * KSTR + cc * CH]) = kk[i];
      *reinterpret_cast<uint4*>(&at.vs[r * kHeadDim + cc * CH]) = vv[i];
    }
    __syncthreads();

    // Scores: dot in f32 of the rounded q and K, then the softmax scale.
    for (int i = tid; i < G * TT; i += blockDim.x) {
      const int g = i / TT, r = i % TT;
      const T* krow = &at.ks[r * KSTR];
      float s = 0.f;
#pragma unroll 4
      for (int c = 0; c < CPR; ++c) {
        float f[CH];
        Elem<T>::unpack(*reinterpret_cast<const uint4*>(krow + c * CH), f);
#pragma unroll
        for (int j = 0; j < CH; ++j) {
          const float kx = kRoundKV ? Elem<M>::round(f[j]) : f[j];
          s = fmaf(at.qs[g][c * CH + j], kx, s);
        }
      }
      at.ps[g][r] = at.valid[r] ? s * a.sm_scale : QT_MASK_VALUE;
    }
    __syncthreads();

    // Online softmax, one warp a head.
    for (int g = warp; g < G; g += kSelThreads / 32) {
      const float m_prev = at.m[g];
      float mx = QT_MASK_VALUE;
      for (int r = lane; r < TT; r += 32) mx = fmaxf(mx, at.ps[g][r]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < TT; r += 32) {
        const float p = at.valid[r] ? expf(at.ps[g][r] - m_new) : 0.f;
        sum += p;
        at.ps[g][r] = Elem<M>::round(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        at.alpha[g] = alpha;
        at.l[g] = alpha * at.l[g] + sum;
        at.m[g] = m_new;
      }
    }
    __syncthreads();

    // PV: thread tid owns output dim tid of every head.
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= at.alpha[g];
    for (int r = 0; r < TT; ++r) {
      float v = Elem<T>::to_float(at.vs[r * kHeadDim + tid]);
      if (kRoundKV) v = Elem<M>::round(v);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(at.ps[g][r], v, acc[g]);
    }
    __syncthreads();
  }

  // 4. Merge the kCluster partials of each query head.
  float* part = reinterpret_cast<float*>(at.ks);  // [G, D]
#pragma unroll
  for (int g = 0; g < G; ++g) part[g * kHeadDim + tid] = acc[g];
  cluster.sync();
  for (int g = rank; g < G; g += kCluster) {
    float mx = QT_MASK_VALUE;
    for (int j = 0; j < kCluster; ++j)
      mx = fmaxf(mx, cluster.map_shared_rank(&at, j)->m[g]);
    float den = 0.f, num = 0.f;
    for (int j = 0; j < kCluster; ++j) {
      const A* pj = cluster.map_shared_rank(&at, j);
      const float w = expf(pj->m[g] - mx);
      den += w * pj->l[g];
      num += w * reinterpret_cast<const float*>(pj->ks)[g * kHeadDim + tid];
    }
    a.out[(qbase + g * kHeadDim) + tid] = den > 0.f ? num / den : 0.f;
  }
  cluster.sync();
}

template <typename T, typename M, int G>
cudaError_t launch_fused(const FusedArgs& a, int B, cudaStream_t stream) {
  const int P = a.NB * a.bpp;
  const size_t smem = static_cast<size_t>(P + (P + kCluster - 1) / kCluster +
                                          a.NB) * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_kernel<T, M, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(kCluster * a.Hkv, B);
  fused_decode_kernel<T, M, G><<<grid, kSelThreads, smem, stream>>>(a);
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

extern "C" int fused_decode_launch(
    const void* q, const void* kv, const void* kmax, const void* kmin,
    const int* tab, const int* seq_lens, float* out, int* ids_out, int B,
    int Hkv, int G, int NP, int page, int NB, int bpp, int K, int kv_bf16,
    int meta_bf16, int agg_sum, int q_bf16, float sm_scale, void* stream) {
  if (K < 1 || K > qt::kMaxBudget) return cudaErrorInvalidValue;
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
