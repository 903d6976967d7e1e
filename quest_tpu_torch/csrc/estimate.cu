// Streaming page-criticality estimate over logical per-page metadata.
//
// Replaces quest_tpu/ops/estimate.py:page_scores_kernel (the Pallas
// kernel _est_kernel, pallas_call at line 229): for each (batch row, KV
// head) and each of its P pages,
//   score = agg_g( relu(q_g) . k_max + min(q_g, 0) . k_min ),
// relu(q) and min(q, 0) rounded to the metadata dtype (bf16 for fp8
// metadata, read with the upcast_fp8 recipe), f32 products, the
// G query rows of the group aggregated by max or sum. The scoring device
// code is the fused decode kernel's (select_common.cuh).
//
// Bound on the H100: bytes. Every metadata row is read once (2 x 256 B
// a page in bf16), 16.8 MB for B=2, 8 KV heads and 2048 pages, against
// 3.35 TB/s; the products are 2 x G x D a page. The design puts the whole
// input in flight at once, in one wave, and keeps the arithmetic off the
// critical path. bf16 and fp8 metadata: each warp takes a tile of 16
// consecutive pages of one head and loads, before anything else, every
// word of their k_max and k_min rows that its lanes feed to the tensor
// cores straight into registers (8 KB a warp in bf16); the CTA rounds the
// query rows into shared memory while they fly; then the warp scores the
// tile (select_common.cuh:tile_scores, the fused kernel's scoring). f32
// metadata: each warp copies W pages' rows into shared memory (16-byte
// cp.async, two halves) and scores each half by FMAs (team_score) as soon
// as it has landed, W the fewest of 4, 8 and 16 that keep the grid within
// eight CTAs an SM.
#include "select_common.cuh"

namespace qt {

constexpr int kEstThreads = 128;
constexpr int kEstWarps = kEstThreads / 32;
constexpr int kEstMinPages = 4, kEstMaxPages = 16;  // pages a warp, f32

// CTAs an SM the registers allow: the tensor-core path holds a tile's
// words (64 registers a lane in bf16), the FMA path 64 registers in all.
template <typename M>
__host__ __device__ constexpr int est_ctas_per_sm() {
  return sizeof(M) == 4 ? 8 : 4;
}

template <typename M, int G>
__global__ void __launch_bounds__(kEstThreads, est_ctas_per_sm<M>())
estimate_kernel(const void* q, const M* kmax, const M* kmin, float* out,
                int Hkv, int P, int W, int agg_sum, int q_bf16) {
  __shared__ float qs[G][kHeadDim];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int64_t head = static_cast<int64_t>(b) * Hkv + h;
  const int w0 = (blockIdx.x * kEstWarps + warp) * W;  // the warp's pages
  const int nw = max(0, min(W, P - w0));
  float* o = out + head * P + w0;
  if constexpr (sizeof(M) <= 2) {
    const int gid = lane >> 2, tig = lane & 3;
    RowWord<M> w[2][8][2];  // [half][step][page gid, gid + 8]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = gid + 8 * r < nw;
      const int64_t row = (head * P + w0 + gid + 8 * r) * kHeadDim;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int kk = 0; kk < 8; kk += 2) {
          w[half][kk][r] = w[half][kk + 1][r] = RowWord<M>{};
          if (ok)
            ldg_row_words((half ? kmin : kmax) + row + step_dim(kk, tig),
                          w[half][kk][r], w[half][kk + 1][r]);
        }
      }
    }
    round_query<M, G>(q, q_bf16, head * G * kHeadDim, qs);
    __syncthreads();  // qs
    QueryFrags<G> qf;
    qf.load(qs);
    float lo, hi;
    tile_scores<M, G>([&](int half, int kk, int r) { return w[half][kk][r]; },
                      qf, agg_sum != 0, lo, hi);
    if (tig == 0) {
      if (gid < nw) o[gid] = lo;
      if (gid + 8 < nw) o[gid + 8] = hi;
    }
  } else {
    // Per warp [2][W][kHeadDim]: its pages' k_max rows, then their k_min
    // rows.
    extern __shared__ __align__(16) unsigned char rows[];
    using Raw = typename TeamRow<M>::Raw;
    constexpr int L = TeamRow<M>::L, E = TeamRow<M>::E, TPW = 32 / L;
    constexpr int CPR = kHeadDim / 4;  // 16-byte copies a row
    M* kx = reinterpret_cast<M*>(rows) + warp * 2 * W * kHeadDim;
    M* kn = kx + W * kHeadDim;
    // Two groups of copies: the first and the second half of the pages.
    for (int half = 0; half < 2; ++half) {
      const int pa = half * (W / 2), pb = half ? nw : min(nw, W / 2);
      for (int i = lane; i < (pb - pa) * 2 * CPR; i += 32) {
        const int pp = pa + i / (2 * CPR), r = (i / CPR) & 1, cc = i % CPR;
        const int64_t src = (head * P + w0 + pp) * kHeadDim + cc * 4;
        cp_async16((r ? kn : kx) + pp * kHeadDim + cc * 4,
                   (r ? kmin : kmax) + src, true);
      }
      cp_async_commit();
    }
    round_query<M, G>(q, q_bf16, head * G * kHeadDim, qs);
    __syncthreads();  // qs
    const int team = lane / L, c = lane % L;
    for (int half = 0; half < 2; ++half) {
      if (half == 0)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncwarp();  // the half's rows, from every lane's copies
      // The same trip count in every lane (W / 2 is a multiple of TPW).
      for (int p = half * (W / 2) + team; p < (half + 1) * (W / 2);
           p += TPW) {
        Raw rx{}, rn{};
        if (p < nw) {
          rx = reinterpret_cast<const Raw*>(kx + p * kHeadDim)[c];
          rn = reinterpret_cast<const Raw*>(kn + p * kHeadDim)[c];
        }
        const float s =
            team_score<M, G>(qs[0] + c * E, kHeadDim, rx, rn, agg_sum != 0);
        if (p < nw && c == 0) o[p] = s;
      }
    }
  }
}

template <typename M, int G>
cudaError_t launch_estimate(const void* q, const void* kmax, const void* kmin,
                            float* out, int B, int Hkv, int P, int agg_sum,
                            int q_bf16, cudaStream_t stream) {
  int W = kScoreTile, smem = 0;
  if (sizeof(M) == 4) {
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
    }
    const auto ctas = [&](int w) {
      return static_cast<int64_t>(B) * Hkv *
             ((P + kEstWarps * w - 1) / (kEstWarps * w));
    };
    W = kEstMinPages;
    while (W < kEstMaxPages &&
           ctas(W) > static_cast<int64_t>(est_ctas_per_sm<M>()) * sms)
      W *= 2;
    smem = kEstWarps * 2 * W * kHeadDim * static_cast<int>(sizeof(M));
    const cudaError_t err = cudaFuncSetAttribute(
        estimate_kernel<M, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((P + kEstWarps * W - 1) / (kEstWarps * W), Hkv, B);
  estimate_kernel<M, G><<<grid, kEstThreads, smem, stream>>>(
      q, static_cast<const M*>(kmax), static_cast<const M*>(kmin), out, Hkv,
      P, W, agg_sum, q_bf16);
  return cudaGetLastError();
}

}  // namespace qt

// q [B, Hkv*G, 128] bf16/f32; kmax, kmin [B, Hkv, P, 128] of dtype code
// meta_dtype (0 f32, 1 bf16, 2 fp8 e4m3), 16-byte aligned; out [B, Hkv,
// P] f32.
extern "C" int estimate_launch(const void* q, const void* kmax,
                               const void* kmin, float* out, int B, int Hkv,
                               int G, int P, int meta_dtype, int agg_sum,
                               int q_bf16, void* stream) {
  if (P < 1 || ((reinterpret_cast<uintptr_t>(kmax) |
                 reinterpret_cast<uintptr_t>(kmin)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define QT_CASE(GG)                                                        \
  case GG:                                                                 \
    err = with_elem(meta_dtype, [&](auto t) {                              \
      return qt::launch_estimate<decltype(t), GG>(q, kmax, kmin, out, B,   \
                                                  Hkv, P, agg_sum, q_bf16, \
                                                  s);                      \
    });                                                                    \
    break;
  switch (G) {
    QT_CASE(1)
    QT_CASE(2)
    QT_CASE(4)
    QT_CASE(8)
    default:
      break;
  }
#undef QT_CASE
  return static_cast<int>(err);
}
