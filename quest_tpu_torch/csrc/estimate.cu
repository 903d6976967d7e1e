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
// Bound on the H100: bytes. A (row, head) reads 2 x 128 elements a page
// (8.4 MB at B=1, 8 KV heads, 2048 bf16 pages; 33.5 MB at 131072 tokens)
// against 2 x G x 128 FMAs. This route's first version (per-lane loads
// through the table, relu(q) and min(q, 0) read from shared memory for
// every FMA) spent more on the products than on the bytes on the H100:
// 14.3 us at 32768 tokens, 9.1 without its products, 5.3 for the launch
// alone (exp/estimate_stages.py). The design: a persistent grid (at most two
// CTAs an SM, phys_plan below) walks units of (row, KV head,
// up to sp pages of one allocation block). A producer warp brings each
// unit into a ring of shared-memory stages: its lane j owns slot j, reads
// the unit's table entry and issues two cp.async.bulk copies (the block's
// contiguous k_max rows, then its k_min rows) completing on the slot's
// mbarrier, so the next units' copies fly while the four consumer warps
// score this one; a block too small for a bulk copy to pay (under 2 KB of
// rows of a kind) comes in by 16-byte cp.async from every lane of the
// warp instead, each table entry read once. The consumers stage the
// unit's query rows in f32 once a (row, KV head); each warp takes a run of
// the unit's pages, four at a time (a team of 16 lanes two pages, 8 dims
// a lane), holds relu(q) and min(q, 0) of four query rows in registers
// across units, widens its rows exactly, runs one FMA an element and sign
// into a k_max and a k_min sum, adds them, reduces the sums of 16 pages
// over the team at once by a transposing butterfly, and hands page j's
// score to lane j: a warp's scores are one contiguous store. No atomics:
// every score is written once, by a lane the plan fixes, so a second
// launch is bitwise equal.
#include <algorithm>

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
constexpr int kPhysConsumers = 4;                        // consumer warps
constexpr int kPhysThreads = (kPhysConsumers + 1) * 32;  // + the producer
constexpr int kPhysRows = 4;        // query rows a warp holds in registers
constexpr int kPhysMaxStages = 16;  // ring stages (bulk: a producer lane each)
constexpr int kPhysMaxPages = 128;  // pages a stage (32 a consumer warp)
constexpr int kPhysLanePages = 64;  // pages a stage on the 16-byte path
constexpr int kPhysBulkMinBytes = 2048;  // a block's rows of a kind: bulk
constexpr int kPhysStageBytes = 32 << 10;  // at most a ring stage
constexpr int kPhysRingBytes = 96 << 10;   // a CTA's ring, two CTAs an SM

// Completes on ``bar`` (one arrival of its count) once every cp.async this
// thread issued before it has landed.
__device__ __forceinline__ void cp_async_bar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The consumer warps' own barrier (bar 0 is __syncthreads).
__device__ __forceinline__ void phys_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kPhysConsumers * 32) : "memory");
}

// Dims of the 8 elements lane c of a 16-lane team takes of a row: 8c..8c+7
// (bf16, fp8: one 16- or 8-byte load), or 4c..4c+3 and 64+4c..64+4c+3
// (f32: two 16-byte loads, each team's loads one contiguous row).
template <typename M>
__device__ __forceinline__ int phys_dim(int c, int half) {
  return sizeof(M) == 4 ? half * 64 + 4 * c : 8 * c + 4 * half;
}

// Lane c's words of a metadata row in shared memory: 16 bytes (bf16), 8
// (fp8, in a.x and a.y) or 32 (f32, a then b).
struct PhysRaw {
  uint4 a, b;
};

template <typename M>
__device__ __forceinline__ PhysRaw phys_load(const unsigned char* row,
                                             int c) {
  PhysRaw r{};
  if constexpr (sizeof(M) == 4) {
    r.a = *reinterpret_cast<const uint4*>(row + 16 * c);
    r.b = *reinterpret_cast<const uint4*>(row + 256 + 16 * c);
  } else if constexpr (sizeof(M) == 2) {
    r.a = *reinterpret_cast<const uint4*>(row + 16 * c);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(row + 8 * c);
    r.a.x = v.x;
    r.a.y = v.y;
  }
  return r;
}

// Those words as 8 f32 elements, widened exactly (fp8 by the hardware
// cvt, which keeps denormals and NaN).
template <typename M>
__device__ __forceinline__ void phys_widen(const PhysRaw& r, float* f) {
  if constexpr (sizeof(M) == 4) {
    const uint4 w[2] = {r.a, r.b};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      f[4 * i] = __uint_as_float(w[i].x);
      f[4 * i + 1] = __uint_as_float(w[i].y);
      f[4 * i + 2] = __uint_as_float(w[i].z);
      f[4 * i + 3] = __uint_as_float(w[i].w);
    }
  } else if constexpr (sizeof(M) == 2) {
    Elem<__nv_bfloat16>::unpack(r.a, f);
  } else {
    const unsigned w[2] = {r.a.x, r.a.y};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __half2 v(__nv_cvt_fp8x2_to_halfraw2(
            static_cast<__nv_fp8x2_storage_t>(w[i] >> (16 * h)), __NV_E4M3));
        const float2 t = __half22float2(v);
        f[4 * i + 2 * h] = t.x;
        f[4 * i + 2 * h + 1] = t.y;
      }
    }
  }
}

// A work unit: np logical pages from page0 of one (row, KV head) bh; on
// the bulk path all of them in allocation block n, from its page off.
struct PhysUnit {
  int bh, page0, np, n, off;
};

__device__ __forceinline__ PhysUnit phys_unit(int u, int upr, int sp,
                                              int bpp, int P, int bulk) {
  PhysUnit w;
  w.bh = u / upr;
  const int r = u % upr;
  if (bulk) {
    const int cpb = (bpp + sp - 1) / sp;  // units a block
    w.n = r / cpb;
    w.off = (r % cpb) * sp;
    w.page0 = w.n * bpp + w.off;
    w.np = min(sp, bpp - w.off);
  } else {
    w.page0 = r * sp;
    w.np = min(sp, P - w.page0);
    w.n = w.off = 0;
  }
  return w;
}

// A consumer warp's query rows in registers: relu(q) and min(q, 0), as
// torch.clamp takes them (NaN kept), of kPhysRows rows from g0 (zeros past
// G), lane c's 8 dims (phys_dim).
template <typename M>
struct PhysQuery {
  float p[kPhysRows][8], n[kPhysRows][8];
  int g0 = -1;  // the rows held; -1: none
  __device__ __forceinline__ void load(const float* qs, int g, int G) {
    const int c = threadIdx.x & 15;
#pragma unroll
    for (int r = 0; r < kPhysRows; ++r) {
      const int row = g + r;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < G)
          x = *reinterpret_cast<const float4*>(
              qs + row * kHeadDim + phys_dim<M>(c, half));
        const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = v[e];
          p[r][4 * half + e] = a != a ? a : fmaxf(a, 0.f);
          n[r][4 * half + e] = a != a ? a : fminf(a, 0.f);
        }
      }
    }
    g0 = g;
  }
};

// Scores one unit's pages in a stage (k_max rows at kx, k_min rows at kn,
// RB bytes a row): this warp takes pages [pw0, pw0 + nw) in batches of 4S
// pages, four a step (each 16-lane team two pages, 8 dims a lane; the
// next step's rows loaded before this step's products), the group's rows
// in chunks of kPhysRows held in registers (q). A lane's 8S sums of a
// batch (its team's 2S pages x 4 rows) are reduced over the team at once
// by a transposing butterfly: at each level a lane keeps half of its
// values and adds the partner's copy of them (31 independent shuffles for
// S = 4 where 32 plain butterflies take 128 dependent ones; 15 for S = 2).
// That leaves lane c with team page (c >> 1) & 7 and rows 2 (c & 1) and
// 2 (c & 1) + 1 (S = 4), or team page (c >> 2) & 3 and row c & 3 (S = 2);
// the rest of the butterfly folds the rows (max or sum, over the group's
// rows only), and lane j takes the batch's page j and writes it: 4S
// consecutive floats.
template <typename M, int S>
__device__ __forceinline__ void phys_score(const unsigned char* kx,
                                           const unsigned char* kn,
                                           int pw0, int nw, const float* qs,
                                           PhysQuery<M>& q, int G, int mode,
                                           float* o, int P) {
  static_assert(S == 2 || S == 4, "batches of 8 or 16 pages");
  constexpr int RB = kHeadDim * sizeof(M);
  constexpr int V = 8 * S;  // a lane's sums of a batch: [team page][row]
  const int lane = threadIdx.x & 31, t = lane >> 4, c = lane & 15;
  const bool b3 = c & 8, b2 = c & 4, b1 = c & 2, b0 = c & 1;
  const bool sum = mode == 1;
  // Batch page j is team (j >> 1) & 1's page 2 (j >> 2) + (j & 1), held by
  // lanes 16 t + (8 / S) (that page) + [0, 8 / S) after the butterfly.
  const int src = ((lane >> 1) & 1) * 16 + (2 * (lane >> 2) + (lane & 1)) *
                                               (8 / S);
  for (int j0 = 0; j0 < nw; j0 += 4 * S) {
    const int nb = min(4 * S, nw - j0);
    float agg = 0.f;
    for (int g0 = 0; g0 < G; g0 += kPhysRows) {
      const int nr = min(kPhysRows, G - g0);
      if (q.g0 != g0) q.load(qs, g0, G);
      PhysRaw nx[2], nn[2];
      const auto fetch = [&](int s) {
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
          const int k = j0 + 4 * s + 2 * t + pl;
          nx[pl] = nn[pl] = PhysRaw{};
          if (k < nw) {
            nx[pl] = phys_load<M>(kx + (pw0 + k) * RB, c);
            nn[pl] = phys_load<M>(kn + (pw0 + k) * RB, c);
          }
        }
      };
      fetch(0);
      float v[V];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const PhysRaw cx[2] = {nx[0], nx[1]}, cn[2] = {nn[0], nn[1]};
        if (s + 1 < S) fetch(s + 1);
#pragma unroll
        for (int pl = 0; pl < 2; ++pl) {
          float fx[8], fn[8];
          phys_widen<M>(cx[pl], fx);
          phys_widen<M>(cn[pl], fn);
#pragma unroll
          for (int r = 0; r < kPhysRows; ++r) {
            // One FMA an element and sign, as the two einsums take them.
            float a = 0.f, b = 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              a = fmaf(q.p[r][e], fx[e], a);
              b = fmaf(q.n[r][e], fn[e], b);
            }
            v[(2 * s + pl) * kPhysRows + r] = a + b;
          }
        }
      }
      float w[V / 2], x[V / 4], y[V / 8], z[V / 16];
#pragma unroll
      for (int i = 0; i < V / 2; ++i)
        w[i] = (b3 ? v[i + V / 2] : v[i]) +
               __shfl_xor_sync(kFull, b3 ? v[i] : v[i + V / 2], 8);
#pragma unroll
      for (int i = 0; i < V / 4; ++i)
        x[i] = (b2 ? w[i + V / 4] : w[i]) +
               __shfl_xor_sync(kFull, b2 ? w[i] : w[i + V / 4], 4);
#pragma unroll
      for (int i = 0; i < V / 8; ++i)
        y[i] = (b1 ? x[i + V / 8] : x[i]) +
               __shfl_xor_sync(kFull, b1 ? x[i] : x[i + V / 8], 2);
#pragma unroll
      for (int i = 0; i < V / 16; ++i)
        z[i] = (b0 ? y[i + V / 16] : y[i]) +
               __shfl_xor_sync(kFull, b0 ? y[i] : y[i + V / 16], 1);
      if (mode == 2) {
#pragma unroll
        for (int r = 0; r < kPhysRows; ++r) {
          float u;
          if constexpr (S == 4)
            u = __shfl_sync(kFull, z[r & 1], src + (r >> 1));
          else
            u = __shfl_sync(kFull, z[0], src + r);
          if (r < nr && lane < nb)
            o[static_cast<int64_t>(g0 + r) * P + pw0 + j0 + lane] = u;
        }
      } else {
        // Fold the rows that exist (r < nr): row bit 0, then row bit 1.
        float own;
        if constexpr (S == 4) {
          own = 2 * b0 + 1 < nr ? fold_agg(z[0], z[1], sum) : z[0];
        } else {
          const int rr = 2 * b1 + b0;
          const float p = __shfl_xor_sync(kFull, z[0], 1);
          own = z[0];
          if ((rr ^ 1) < nr) own = rr < nr ? fold_agg(own, p, sum) : p;
        }
        const bool hi = S == 4 ? b0 : b1;  // the lane's row bit 1
        const float pr = __shfl_xor_sync(kFull, own, S == 4 ? 1 : 2);
        if (2 * !hi < nr) own = 2 * hi < nr ? fold_agg(own, pr, sum) : pr;
        const float u = __shfl_sync(kFull, own, src);
        agg = g0 == 0 ? u : fold_agg(agg, u, sum);
      }
    }
    if (mode != 2 && lane < nb) o[pw0 + j0 + lane] = agg;
  }
}

// mode: 0 max over the group, 1 sum, 2 one score a query head.
// A persistent grid: CTA i takes units [i * units / grid, (i + 1) * units /
// grid) of the (row, KV head, pages) units, in order. Dynamic shared
// memory: the ring (stages of sp pages' k_max rows, then their k_min
// rows), then the unit's query rows in f32 [G][kHeadDim].
template <typename M>
__global__ void __launch_bounds__(kPhysThreads, 2)
estimate_physical_kernel(const void* q, const M* kmax, const M* kmin,
                         const int* block_tab, float* out, int Hkv, int G,
                         int NPB, int bpp, int NB, int mode, int q_bf16,
                         int sp, int stages, int bulk, int units) {
  constexpr int RB = kHeadDim * sizeof(M);  // bytes a metadata row
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kPhysMaxStages],
      empty[kPhysMaxStages];
#ifdef QT_EST_EMPTY  // ablation (exp/estimate_stages.py): the launch alone
  return;
#endif
  const int stage_bytes = 2 * sp * RB;
  float* qs = reinterpret_cast<float*>(ring + stages * stage_bytes);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = NB * bpp;
  const int upr = bulk ? NB * ((bpp + sp - 1) / sp) : (P + sp - 1) / sp;
  const int u0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * units /
                                  gridDim.x);
  const int nu = static_cast<int>(
      static_cast<int64_t>(blockIdx.x + 1) * units / gridDim.x) - u0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], bulk ? 1 : 32);
      bar_init(&empty[s], kPhysConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kPhysConsumers) {
    const unsigned char* gx = reinterpret_cast<const unsigned char*>(kmax);
    const unsigned char* gn = reinterpret_cast<const unsigned char*>(kmin);
    if (bulk) {
      // Lane j < stages owns ring slot j and brings units j, j + stages,
      // ... into it, each once the consumers have released the slot's
      // previous unit: one table entry and two copies (the block's k_max
      // rows, its k_min rows) a unit, the lanes' waits and copies
      // overlapping.
      for (int i = lane; lane < stages && i < nu; i += stages) {
        const int k = i / stages;
        if (k > 0) bar_wait(&empty[lane], (k - 1) & 1);
        const PhysUnit w = phys_unit(u0 + i, upr, sp, bpp, P, 1);
        const int b = w.bh / Hkv, h = w.bh % Hkv;
#ifdef QT_EST_NO_TABLE  // ablation: the block read without the table
        const int blk = w.n;
#else
        const int blk = __ldg(block_tab + static_cast<int64_t>(b) * NB + w.n);
#endif
        const int64_t at =
            ((static_cast<int64_t>(h) * NPB + blk) * bpp + w.off) * RB;
        const uint32_t bytes = w.np * RB;
        unsigned char* dst = ring + lane * stage_bytes;
#ifdef QT_EST_NO_LOAD  // ablation: the table read, no copy
        if (blk != -1) {
          bar_arrive(&full[lane]);
          continue;
        }
#endif
        bar_expect(&full[lane], 2 * bytes);
        bulk_g2s(dst, gx + at, bytes, &full[lane]);
        bulk_g2s(dst + sp * RB, gn + at, bytes, &full[lane]);
      }
    } else {
      // Blocks too small for a bulk copy: the warp brings each unit's
      // rows by 16-byte cp.async, consecutive lanes along a row, each
      // row's table entry read once (a lane an entry, handed round by
      // shuffle), and every lane's copies complete on the slot's barrier.
      constexpr int CPR = RB / 16;  // 16-byte pieces a row
      for (int i = 0; i < nu; ++i) {
        const int slot = i % stages, k = i / stages;
        if (k > 0) bar_wait(&empty[slot], (k - 1) & 1);
        const PhysUnit w = phys_unit(u0 + i, upr, sp, bpp, P, 0);
        const int b = w.bh / Hkv, h = w.bh % Hkv;
        const int nb0 = w.page0 / bpp;
        const int nbl = (w.page0 + w.np - 1) / bpp - nb0 + 1;  // <= 64
        const int* row_tab = block_tab + static_cast<int64_t>(b) * NB + nb0;
#ifdef QT_EST_NO_TABLE
        const int e0 = nb0 + lane, e1 = nb0 + 32 + lane;
#else
        const int e0 = lane < nbl ? __ldg(row_tab + lane) : 0;
        const int e1 = lane + 32 < nbl ? __ldg(row_tab + 32 + lane) : 0;
#endif
        unsigned char* dst = ring + slot * stage_bytes;
        const int pieces = w.np * 2 * CPR;
        for (int j = lane; j < ((pieces + 31) & ~31); j += 32) {
          const int ip = j / (2 * CPR), kind = (j / CPR) & 1, ch = j % CPR;
          const int p = w.page0 + ip;
          const int rel = p / bpp - nb0;
          const int lo = __shfl_sync(kFull, e0, rel & 31);
          const int hi = __shfl_sync(kFull, e1, rel & 31);
          if (j < pieces) {
            const int blk = rel < 32 ? lo : hi;
            const int64_t at =
                ((static_cast<int64_t>(h) * NPB + blk) * bpp + p % bpp) * RB +
                16 * ch;
#ifdef QT_EST_NO_LOAD
            if (blk == -1)
#endif
              cp_async16(dst + kind * sp * RB + ip * RB + 16 * ch,
                         (kind ? gn : gx) + at, true);
          }
        }
        cp_async_bar_arrive(&full[slot]);
      }
      cp_async_wait<0>();
    }
    return;
  }

  // Consumer warps: every unit in order, each warp its run of the unit's
  // pages; the unit's query rows staged in f32 once a (row, KV head).
  const int ppw = ((sp + 4 * kPhysConsumers - 1) / (4 * kPhysConsumers)) * 4;
  const int pw0 = warp * ppw;
  int cur = -1;
  PhysQuery<M> qr;
  for (int i = 0; i < nu; ++i) {
    const int slot = i % stages;
    const PhysUnit w = phys_unit(u0 + i, upr, sp, bpp, P, bulk);
    if (w.bh != cur) {
      if (cur >= 0) phys_consumers_sync();  // every warp is done with qs
      const int64_t q0 = static_cast<int64_t>(w.bh) * G * kHeadDim;
      for (int j = threadIdx.x; j < G * kHeadDim; j += kPhysConsumers * 32)
        qs[j] = q_bf16 ? __bfloat162float(
                             static_cast<const __nv_bfloat16*>(q)[q0 + j])
                       : static_cast<const float*>(q)[q0 + j];
      phys_consumers_sync();
      cur = w.bh;
      qr.g0 = -1;
    }
    bar_wait(&full[slot], (i / stages) & 1);
    const unsigned char* st = ring + slot * stage_bytes;
    const int nw = min(ppw, w.np - pw0);
    float* o = out + static_cast<int64_t>(w.bh) * (mode == 2 ? G : 1) * P +
               w.page0;
    if (nw > 0) {
#ifdef QT_EST_NO_MATH  // ablation: the rows land, no products
      if (lane < nw) o[pw0 + lane] = 0.f;
#else
      if (ppw % 16 == 0)
        phys_score<M, 4>(st, st + sp * RB, pw0, nw, qs, qr, G, mode, o, P);
      else
        phys_score<M, 2>(st, st + sp * RB, pw0, nw, qs, qr, G, mode, o, P);
#endif
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[slot]);  // the slot may be refilled
  }
}

// The launch plan of the physical route. A unit is a block's pages (a stage
// of at most 32 KB; a larger block splits into units of sp pages, the last
// one partial), or, where a block's rows of a kind are under 2 KB, the next
// sp pages of the row by 16-byte copies; as many stages as 96 KB holds (2
// to 16); as many CTAs an SM as the runtime's occupancy gives, at most two,
// and no more CTAs than units.
struct PhysPlan {
  int bulk, sp, stages, grid, smem, ctas;
  int64_t units;
};

template <typename M>
cudaError_t phys_plan(int B, int Hkv, int G, int bpp, int NB, PhysPlan* p) {
  constexpr int RB = kHeadDim * static_cast<int>(sizeof(M));
  p->bulk = bpp * RB >= kPhysBulkMinBytes;
  const int cap = std::min(p->bulk ? kPhysMaxPages : kPhysLanePages,
                           kPhysStageBytes / (2 * RB));
  p->sp = p->bulk ? std::min(bpp, cap) : cap;
#ifdef QT_EST_STAGE_PAGES  // ablation (exp/estimate_stages.py --sweep)
  p->sp = std::min(p->sp, QT_EST_STAGE_PAGES);
#endif
  const int stage = 2 * p->sp * RB;
  p->stages = std::max(2, std::min(kPhysMaxStages, kPhysRingBytes / stage));
  const int64_t P = static_cast<int64_t>(NB) * bpp;
  const int64_t upr =
      p->bulk ? NB * static_cast<int64_t>((bpp + p->sp - 1) / p->sp)
              : (P + p->sp - 1) / p->sp;
  p->units = static_cast<int64_t>(B) * Hkv * upr;
  p->smem = p->stages * stage + G * kHeadDim * 4;
  if (p->units > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (p->smem > 48 * 1024)
    err = cudaFuncSetAttribute(estimate_physical_kernel<M>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p->smem);
  int occ = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, estimate_physical_kernel<M>, kPhysThreads, p->smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p->ctas = std::min(2, occ);
  if (p->ctas < 1) return cudaErrorInvalidValue;
  p->grid = static_cast<int>(
      std::min(p->units, static_cast<int64_t>(p->ctas) * sms));
  return cudaSuccess;
}

template <typename M>
cudaError_t launch_estimate_physical(const void* q, const void* kmax,
                                     const void* kmin, const int* block_tab,
                                     float* out, int B, int Hkv, int G,
                                     int NPB, int bpp, int NB, int mode,
                                     int q_bf16, cudaStream_t stream) {
  PhysPlan p;
  const cudaError_t err = phys_plan<M>(B, Hkv, G, bpp, NB, &p);
  if (err != cudaSuccess) return err;
  estimate_physical_kernel<M><<<p.grid, kPhysThreads, p.smem, stream>>>(
      q, static_cast<const M*>(kmax), static_cast<const M*>(kmin), block_tab,
      out, Hkv, G, NPB, bpp, NB, mode, q_bf16, p.sp, p.stages, p.bulk,
      static_cast<int>(p.units));
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

// The plan estimate_physical_launch takes for these shapes on the current
// device, into plan[7]: bulk, pages a stage, stages, units, grid, dynamic
// shared memory bytes, CTAs an SM.
extern "C" int estimate_physical_plan(int B, int Hkv, int G, int bpp, int NB,
                                      int meta_dtype, int64_t* plan) {
  if (B < 1 || Hkv < 1 || G < 1 || G > 128 || bpp < 1 || NB < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_elem(meta_dtype, [&](auto t) {
    qt::PhysPlan p;
    const cudaError_t err = qt::phys_plan<decltype(t)>(B, Hkv, G, bpp, NB, &p);
    const int64_t v[7] = {p.bulk, p.sp, p.stages, p.units, p.grid, p.smem,
                          p.ctas};
    if (err == cudaSuccess)
      for (int i = 0; i < 7; ++i) plan[i] = v[i];
    return err;
  }));
}
