// Streaming page-criticality estimate over logical per-page metadata.
//
// Replaces quest_tpu/ops/estimate.py:page_scores_kernel (the Pallas
// kernel _est_kernel, pallas_call at line 229): for each (batch row, KV
// head) and each of its P pages,
//   score = agg_g( relu(q_g) . k_max + min(q_g, 0) . k_min ),
// relu(q) and min(q, 0) rounded to the metadata dtype (bf16 for fp8
// metadata, read with the upcast_fp8 recipe), f32 products, the
// G query rows of the group aggregated by max or sum. Any G: the rows
// are scored in blocks of 8 whose partial scores fold by the same agg.
// The scoring device code is the fused decode kernel's
// (select_common.cuh).
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
//
// The physical route (estimate_physical_launch) is the unfused decode
// step's estimate, the counterpart of the XLA fusion that the JAX package
// runs for quest_tpu/ops/estimate.py:page_scores_physical (the einsums at
// lines 83-151): for each batch row b, KV head h and logical page p of the
// row's block table,
//   score = agg_g( relu(q_g) . k_max[phys] + min(q_g, 0) . k_min[phys] ),
// phys = block_tab[b][p / bpp] * bpp + p % bpp, the metadata keyed by
// physical page ([Hkv, NPB, bpp, 128], one layer), q kept in f32 (no
// rounding to the metadata dtype) and the metadata widened exactly to f32
// (fp8 by the hardware cvt, which keeps denormals, as PyTorch's cast does),
// f32 FMAs; agg is max or sum over the group, or none (per query head).
// Each row's pages are read through its own table, so a block that rows
// share, or the scratch block of an idle slot, is read once a row that
// points at it; nothing assumes rows own disjoint memory.
// Bound on the H100: bytes. A row reads 2 x 128 elements a page and head
// (8.4 MB at B=1, 8 KV heads, 2048 bf16 pages), 2 x G x 128 FMAs against
// them. Each lane loads 16 bytes of a k_max row and 16 of the k_min row
// (a team of 8, 16 or 32 lanes a page for fp8, bf16, f32), kPhysU pages a
// lane, every load issued before the CTA stages relu(q) and min(q, 0) in
// shared memory; then each team widens its rows, runs the FMAs, and sums
// over the team by butterfly, one query row at a time.
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

// Dynamic shared memory: the G rounded query rows, then (f32 metadata)
// the warps' metadata rows.
template <typename M>
__global__ void __launch_bounds__(kEstThreads, est_ctas_per_sm<M>())
estimate_kernel(const void* q, const M* kmax, const M* kmin, float* out,
                int Hkv, int G, int P, int W, int agg_sum, int q_bf16) {
  extern __shared__ __align__(16) unsigned char dyn[];
  float(*qs)[kHeadDim] = reinterpret_cast<float(*)[kHeadDim]>(dyn);
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
    round_query<M>(q, q_bf16, head * G * kHeadDim, G, G, qs);
    __syncthreads();  // qs
    QueryFrags qf;
    qf.load(qs, min(G, 8));
    float lo, hi;
    tile_scores_any<M>([&](int half, int kk, int r) { return w[half][kk][r]; },
                       qf, qs, G, agg_sum != 0, lo, hi);
    if (tig == 0) {
      if (gid < nw) o[gid] = lo;
      if (gid + 8 < nw) o[gid + 8] = hi;
    }
  } else {
    // Per warp [2][W][kHeadDim]: its pages' k_max rows, then their k_min
    // rows.
    unsigned char* rows = dyn + G * kHeadDim * sizeof(float);
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
    round_query<M>(q, q_bf16, head * G * kHeadDim, G, G, qs);
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
        const float s = team_score_any<M>(qs[0] + c * E, G, rx, rn,
                                          agg_sum != 0);
        if (p < nw && c == 0) o[p] = s;
      }
    }
  }
}

template <typename M>
cudaError_t launch_estimate(const void* q, const void* kmax, const void* kmin,
                            float* out, int B, int Hkv, int G, int P,
                            int agg_sum, int q_bf16, cudaStream_t stream) {
  int W = kScoreTile;
  int smem = G * kHeadDim * static_cast<int>(sizeof(float));
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
    smem += kEstWarps * 2 * W * kHeadDim * static_cast<int>(sizeof(M));
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        estimate_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((P + kEstWarps * W - 1) / (kEstWarps * W), Hkv, B);
  estimate_kernel<M><<<grid, kEstThreads, smem, stream>>>(
      q, static_cast<const M*>(kmax), static_cast<const M*>(kmin), out, Hkv,
      G, P, W, agg_sum, q_bf16);
  return cudaGetLastError();
}

// ---- The physical route. ----
constexpr int kPhysThreads = 256;
constexpr int kPhysWarps = kPhysThreads / 32;
constexpr int kPhysU = 2;  // pages a lane's loads cover

// The 16 bytes a lane loads of a metadata row, widened exactly to f32.
template <typename M>
__device__ __forceinline__ void widen16(const uint4& raw, float* f) {
  if constexpr (sizeof(M) == 1) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __half2 v(__nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * h)), __NV_E4M3));
        const float2 t = __half22float2(v);
        f[4 * i + 2 * h] = t.x;
        f[4 * i + 2 * h + 1] = t.y;
      }
    }
  } else {
    Elem<M>::unpack(raw, f);
  }
}

// mode: 0 max over the group, 1 sum, 2 one score a query head.
// Dynamic shared memory: relu(q) then min(q, 0), [G][kHeadDim] f32 each.
template <typename M>
__global__ void __launch_bounds__(kPhysThreads)
estimate_physical_kernel(const void* q, const M* kmax, const M* kmin,
                         const int* block_tab, float* out, int Hkv, int G,
                         int NPB, int bpp, int NB, int mode, int q_bf16) {
  extern __shared__ __align__(16) float qsp[];
  constexpr int E = 16 / sizeof(M);   // elements a lane loads a row
  constexpr int L = kHeadDim / E;     // lanes a page
  constexpr int T = 32 / L;           // pages a warp takes at once
  float* qsn = qsp + G * kHeadDim;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = lane / L, c = lane % L;
  const int h = blockIdx.y, b = blockIdx.z;
  const int P = NB * bpp;
  const int p0 = blockIdx.x * kPhysWarps * T * kPhysU;
  uint4 rx[kPhysU], rn[kPhysU];
#pragma unroll
  for (int u = 0; u < kPhysU; ++u) {
    const int p = p0 + (u * kPhysWarps + warp) * T + team;
    rx[u] = rn[u] = uint4{0u, 0u, 0u, 0u};
    if (p < P) {
      const int blk = __ldg(block_tab + static_cast<int64_t>(b) * NB + p / bpp);
      const int64_t row =
          ((static_cast<int64_t>(h) * NPB + blk) * bpp + p % bpp) * kHeadDim +
          c * E;
      rx[u] = __ldg(reinterpret_cast<const uint4*>(kmax + row));
      rn[u] = __ldg(reinterpret_cast<const uint4*>(kmin + row));
    }
  }
  const int64_t qbase = (static_cast<int64_t>(b) * Hkv + h) * G * kHeadDim;
  for (int i = threadIdx.x; i < G * kHeadDim; i += blockDim.x) {
    const float x =
        q_bf16 ? __bfloat162float(
                     static_cast<const __nv_bfloat16*>(q)[qbase + i])
               : static_cast<const float*>(q)[qbase + i];
    qsp[i] = fmaxf(x, 0.f);
    qsn[i] = fminf(x, 0.f);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kPhysU; ++u) {
    const int p = p0 + (u * kPhysWarps + warp) * T + team;
    float fx[E], fn[E];
    widen16<M>(rx[u], fx);
    widen16<M>(rn[u], fn);
    float agg = 0.f;
    for (int g = 0; g < G; ++g) {  // the same in every lane
      const float4* ap = reinterpret_cast<const float4*>(qsp + g * kHeadDim + c * E);
      const float4* an = reinterpret_cast<const float4*>(qsn + g * kHeadDim + c * E);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < E / 4; ++j) {
        const float4 a = ap[j], n = an[j];
        s = fmaf(a.x, fx[4 * j], s);
        s = fmaf(a.y, fx[4 * j + 1], s);
        s = fmaf(a.z, fx[4 * j + 2], s);
        s = fmaf(a.w, fx[4 * j + 3], s);
        s = fmaf(n.x, fn[4 * j], s);
        s = fmaf(n.y, fn[4 * j + 1], s);
        s = fmaf(n.z, fn[4 * j + 2], s);
        s = fmaf(n.w, fn[4 * j + 3], s);
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      if (mode == 2) {
        if (c == 0 && p < P)
          out[((static_cast<int64_t>(b) * Hkv + h) * G + g) * P + p] = s;
      } else {
        agg = g == 0 ? s : fold_agg(agg, s, mode == 1);
      }
    }
    if (mode != 2 && c == 0 && p < P)
      out[(static_cast<int64_t>(b) * Hkv + h) * P + p] = agg;
  }
}

template <typename M>
cudaError_t launch_estimate_physical(const void* q, const void* kmax,
                                     const void* kmin, const int* block_tab,
                                     float* out, int B, int Hkv, int G,
                                     int NPB, int bpp, int NB, int mode,
                                     int q_bf16, cudaStream_t stream) {
  constexpr int T = 32 / (kHeadDim / (16 / static_cast<int>(sizeof(M))));
  const int smem = 2 * G * kHeadDim * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        estimate_physical_kernel<M>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int per_cta = kPhysWarps * T * kPhysU;
  dim3 grid((NB * bpp + per_cta - 1) / per_cta, Hkv, B);
  estimate_physical_kernel<M><<<grid, kPhysThreads, smem, stream>>>(
      q, static_cast<const M*>(kmax), static_cast<const M*>(kmin), block_tab,
      out, Hkv, G, NPB, bpp, NB, mode, q_bf16);
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
  if (P < 1 || G < 1 || G > 256 ||
      ((reinterpret_cast<uintptr_t>(kmax) |
        reinterpret_cast<uintptr_t>(kmin)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_elem(meta_dtype, [&](auto t) {
    return qt::launch_estimate<decltype(t)>(q, kmax, kmin, out, B, Hkv, G, P,
                                            agg_sum, q_bf16, s);
  }));
}

// The physical route. q [B, Hkv*G, 128] bf16/f32 (kept in f32); kmax,
// kmin [Hkv, NPB, bpp, 128] of dtype code meta_dtype, 16-byte aligned;
// block_tab [B, NB] int32, entries in [0, NPB); out [B, Hkv, NB*bpp] f32
// (mode 0 max, 1 sum), or [B, Hkv*G, NB*bpp] (mode 2, per query head).
extern "C" int estimate_physical_launch(const void* q, const void* kmax,
                                        const void* kmin,
                                        const int* block_tab, float* out,
                                        int B, int Hkv, int G, int NPB,
                                        int bpp, int NB, int meta_dtype,
                                        int mode, int q_bf16, void* stream) {
  if (B < 1 || Hkv < 1 || G < 1 || G > 128 || NPB < 1 || bpp < 1 ||
      NB < 1 || mode < 0 || mode > 2 ||
      ((reinterpret_cast<uintptr_t>(kmax) |
        reinterpret_cast<uintptr_t>(kmin)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_elem(meta_dtype, [&](auto t) {
    return qt::launch_estimate_physical<decltype(t)>(
        q, kmax, kmin, block_tab, out, B, Hkv, G, NPB, bpp, NB, mode, q_bf16,
        s);
  }));
}
