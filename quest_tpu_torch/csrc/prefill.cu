// Causal paged flash-prefill attention.
//
// Replaces quest_tpu/ops/prefill.py:prefill_attention (the Pallas
// kernels _kernel and _kernel_shared, pallas_call at line 245). T new
// queries of a slot sit at absolute positions q_offset + i and attend
// to the slot's cached tokens k <= q_offset + i and k < kv_len (the new
// tokens are already appended), read through the block table. Chunked
// prefill is q_offset > 0. Padded query rows (i past the real chunk)
// have q_offset + i >= kv_len and see every cached token, so their
// softmax sum is positive whenever kv_len > 0; a row with no key at
// all (kv_len == 0, an empty row of a batch) writes zeros.
//
// Bound on the H100: operations. Causal attention of T = 2048 fresh
// queries of Llama-3.1-8B (32 query heads, D = 128) is about
// 4 * 32 * 128 * 2048 * 1024 = 34 GFLOP, against 989 TFLOP/s of bf16
// tensor cores (NVIDIA H100 SXM data sheet, 700 W).
//
// bf16 and fp8 e4m3 pools: prefill_tma_kernel, built for Hopper.
// - One CTA owns (KV head, batch row, query tile). Its kM = 128 rows are
//   128 / G query positions x the G query heads of the KV head (row r:
//   position i0 + r / G, head r % G), so every K/V tile reaches shared
//   memory once for the whole GQA group. G is 1, 2, 4 or 8.
// - One producer warp loads each 128-token K/V tile by TMA, one box a
//   page and 64-column half (128-byte swizzle, as wgmma reads it), from a
//   tensor map over the layer's pool seen as rows of 128 elements
//   [Hkv * NP * 2 * page, 128]; lane p reads the block table for page p
//   of the tile one tile ahead. Pages past the CTA's causal bound or the
//   block table are loaded from past the map's last row, which TMA fills
//   with zeros, so no tile holds stale values and no table entry past
//   NB * bpp is read; keys past the table are masked (kv_len is clamped
//   to NB * bpp * page). Tiles past the causal bound are never loaded.
// - Tiles sit in a ring of three stages (two over fp8), with full and
//   empty mbarriers.
// - Two consumer warpgroups of 64 rows each (setmaxnreg moves registers
//   from the producer to them): S = Q K^T by wgmma with both operands in
//   swizzled shared memory, the online softmax in registers (the causal
//   and length mask only on the tiles that need it), P re-packed from
//   the S accumulators as wgmma's register A operand (rounded to bf16
//   there, as the JAX kernel rounds p), O += P V with V as the
//   transposed (MN-major) B operand.
// - q arrives unscaled; each consumer multiplies its 64 rows by the
//   softmax scale in f32 and rounds them to bf16 as it stores them.
// - fp8 pools: TMA brings each fp8 tile into one of two staging buffers;
//   the producer warpgroup widens it with the upcast_fp8 recipe
//   (fp8x16_to_bf16, common.cuh) into the swizzled bf16 ring, a pipeline
//   stage of its own, so the widening of tile j + 1 overlaps the products
//   of tile j. q and p stay bf16 (the JAX contract), so fp8 wgmma is not
//   used.
// - Heaviest (latest) query tiles launch first.
// Left for later: overlapping one warpgroup's softmax with the other's
// products by explicit scheduling, and a persistent grid.
//
// f32 pools (off the serving path, which keeps bf16 KV) take a plain
// FMA kernel, prefill_f32_kernel: the contract there is f32 products
// throughout, which bf16 tensor cores cannot keep.
#include <cuda.h>  // CUtensorMap and its enums; the driver entry point is
                   // found at run time (cudaGetDriverEntryPoint), no -lcuda
#include <string.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 128;

// ---------------------------------------------------------------------------
// bf16 and fp8 pools: TMA + wgmma.
// ---------------------------------------------------------------------------

constexpr int kM = 128;                      // query rows a CTA
constexpr int kBK = 128;                     // tokens a K/V tile
// K/V ring depth: three bf16 stages (2-4% faster than two on an H100 80GB
// HBM3 at 700 W, PERF.md); fp8 pools two, beside two fp8 staging buffers
// (224 KB of shared memory either way).
__host__ __device__ constexpr int ring_stages(bool fp8) {
  return fp8 ? 2 : 3;
}
constexpr int kConsumers = 2;                // warpgroups of 64 rows
constexpr int kTmaThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 56;            // 128 * 56 + 256 * 224 <= 64 K
constexpr int kConsumerRegs = 224;
constexpr int kHalf = kBK * 64 * 2;          // one 64-column bf16 half tile
constexpr int kTile = 2 * kHalf;             // one bf16 K or V tile, 32 KB
constexpr int kStage = 2 * kTile;            // K and V
constexpr int kQBytes = kM * kD * 2;         // the bf16 Q tile, 32 KB
constexpr int kTile8 = kBK * kD;             // one fp8 K or V tile, 16 KB
constexpr int kStage8 = 2 * kTile8;
constexpr float kLog2e = 1.4426950408889634f;

template <bool kFp8>
constexpr size_t tma_smem() {
  constexpr int kStages = ring_stages(kFp8);
  return 1024 /* alignment slack */ + kQBytes + kStages * kStage +
         (kFp8 ? kStages * kStage8 : 0) + 3 * kStages * sizeof(uint64_t);
}

struct TmaArgs {
  const void* q;             // [B, T, Hq, D] bf16 or f32, un-scaled
  const int* tab;            // [B, NB]
  const int* q_offsets;      // [B]
  const int* kv_lens;        // [B]
  float* out;                // [B, T, Hq, D]
  int T, Hq, G, NP, page, NB, bpp;
  int rows;                  // rows of the tensor map: Hkv * NP * 2 * page
  float sm_scale;
  int q_bf16;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Eight query elements from global memory (bf16 or f32), scaled.
__device__ __forceinline__ uint4 load_q8(const void* q, int64_t at, int q_bf16,
                                         float sm_scale) {
  float x[8];
  if (q_bf16) {
    Elem<bf16>::unpack(__ldg(reinterpret_cast<const uint4*>(
                           static_cast<const bf16*>(q) + at)), x);
  } else {
    const float4* p = reinterpret_cast<const float4*>(
        static_cast<const float*>(q) + at);
    const float4 lo = __ldg(p), hi = __ldg(p + 1);
    x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
    x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
  }
  return make_uint4(pack_bf16(x[0] * sm_scale, x[1] * sm_scale),
                    pack_bf16(x[2] * sm_scale, x[3] * sm_scale),
                    pack_bf16(x[4] * sm_scale, x[5] * sm_scale),
                    pack_bf16(x[6] * sm_scale, x[7] * sm_scale));
}

// One box of the tensor map (columns x.., rows y..) into shared memory,
// completing on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

// 2^x on the special-function unit (one instruction; exp2f adds range
// handling). Underflows to +0, as the masked scores need.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units). K-major (Q, K): rows of 128
// bytes, sbo = 1024 between 8-row groups, lbo unused. MN-major (V): lbo
// between 64-column halves, sbo between 8-token groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define QT_D64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"
#define QT_F8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define QT_F64                                                       \
  QT_F8(0), QT_F8(8), QT_F8(16), QT_F8(24), QT_F8(32), QT_F8(40), \
      QT_F8(48), QT_F8(56)

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory, B
// K-major; bf16 in, f32 accumulate. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " QT_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : QT_F64
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A from registers (the
// accumulator layout of a 64 x 16 slice, packed bf16 pairs), B from shared
// memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " QT_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : QT_F64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef QT_D64
#undef QT_F8
#undef QT_F64

template <bool kFp8>
__global__ void __launch_bounds__(kTmaThreads, 1)
prefill_tma_kernel(const __grid_constant__ CUtensorMap tmap, const TmaArgs a) {
  constexpr int kStages = ring_stages(kFp8);
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned: the 128-byte swizzle repeats every 8 rows of 128 B.
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;                     // [2 wg][2 halves][64][64]
  unsigned char* ring = qs + kQBytes;           // kStages x [K, V] bf16
  unsigned char* stage8 = ring + kStages * kStage;   // fp8: kStages x [K, V]
  uint64_t* full = reinterpret_cast<uint64_t*>(
      stage8 + (kFp8 ? kStages * kStage8 : 0));
  uint64_t* empty = full + kStages;
  uint64_t* sfull = empty + kStages;            // fp8 staging loaded

  const int P = kM / a.G;                       // query positions a CTA
  const int h_kv = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * P;   // heaviest first
  const int offset = a.q_offsets[b];
  // Keys past the block table do not exist (as in the plain version).
  const int kv_len = min(a.kv_lens[b], a.NB * a.bpp * a.page);
  const int hi = min(offset + i0 + P, kv_len);  // keys this CTA can see
  const int n_tiles = hi > 0 ? (hi + kBK - 1) / kBK : 0;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], kFp8 ? 128 : 1);       // fp8: every widening thread
      bar_init(&empty[s], kConsumers * 128);
      if (kFp8) bar_init(&sfull[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int ppt = kBK / a.page;               // pages a tile
    // First pool row of page `lane` of tile j (its K rows; V follows
    // `page` rows later), or a.rows (past the map: zeros) where the page
    // is past the CTA's keys or the block table.
    auto page_row = [&](int j) -> int {
      const int lp = j * ppt + lane;
      if (lane >= ppt || lp * a.page >= hi || lp >= a.NB * a.bpp) return a.rows;
      return (h_kv * a.NP + phys_page(a.tab, b, a.NB, a.bpp, lp)) * 2 * a.page;
    };
    if constexpr (!kFp8) {
      if (warp == 0) {
        int row = page_row(0);
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % kStages;
          const int next = page_row(j + 1);       // in flight during the wait
          if (j >= kStages) bar_wait(&empty[s], (j / kStages - 1) & 1);
          if (lane == 0) bar_expect(&full[s], kStage);
          __syncwarp();
          if (lane < ppt) {
            unsigned char* k = ring + s * kStage + lane * a.page * 128;
            tma_load(k, &tmap, 0, row, &full[s]);
            tma_load(k + kHalf, &tmap, 64, row, &full[s]);
            tma_load(k + kTile, &tmap, 0, row + a.page, &full[s]);
            tma_load(k + kTile + kHalf, &tmap, 64, row + a.page, &full[s]);
          }
          row = next;
        }
      }
    } else {
      // Warp 0 loads fp8 tiles into staging; all four warps widen them.
      int row = 0;
      auto load_tile = [&](int j) {
        const int s = j % kStages;
        const int next = page_row(j + 1);
        if (lane == 0) bar_expect(&sfull[s], kStage8);
        __syncwarp();
        if (lane < ppt) {
          unsigned char* k = stage8 + s * kStage8 + lane * a.page * 128;
          tma_load(k, &tmap, 0, row, &sfull[s]);
          tma_load(k + kTile8, &tmap, 0, row + a.page, &sfull[s]);
        }
        row = next;
      };
      if (warp == 0) {
        row = page_row(0);
        for (int j = 0; j < min(kStages, n_tiles); ++j) load_tile(j);
      }
      const int c = tid % 8;                    // 16-byte fp8 chunk of a row
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        bar_wait(&sfull[s], (j / kStages) & 1);
        if (j >= kStages) bar_wait(&empty[s], (j / kStages - 1) & 1);
        const unsigned char* src = stage8 + s * kStage8;
        unsigned char* dst = ring + s * kStage;
#pragma unroll 2
        for (int i = 0; i < 2 * kBK / 16; ++i) {
          const int r = tid / 8 + 16 * i;       // K rows, then V rows
          const int t = r % kBK;
          const uint4 raw = *reinterpret_cast<const uint4*>(
              src + (r / kBK) * kTile8 + t * 128 + c * 16);
          uint4 lo, hi8;
          fp8x16_to_bf16(raw, lo, hi8);         // bf16 elements 16c..16c+15
          // Element e of row t: half e / 64, 16-byte chunk (e % 64) / 8,
          // swizzled with t % 8. Threads c >= 4 store their high chunk
          // first, so the 8 threads of a store phase hit 8 bank groups.
          unsigned char* base = dst + (r / kBK) * kTile + (c / 4) * kHalf +
                                t * 128;
          const int c0 = (2 * (c % 4)) ^ (t % 8), c1 = c0 ^ 1;
          const bool swap = c >= 4;
          *reinterpret_cast<uint4*>(base + (swap ? c1 : c0) * 16) =
              swap ? hi8 : lo;
          *reinterpret_cast<uint4*>(base + (swap ? c0 : c1) * 16) =
              swap ? lo : hi8;
        }
        fence_async_smem();                     // visible to wgmma
        bar_arrive(&full[s]);
        named_sync(1, 128);                     // staging s is read
        if (warp == 0 && j + kStages < n_tiles) load_tile(j + kStages);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    // This warpgroup's 64 query rows, scaled, as two 128-byte-swizzled
    // halves [64 rows][64 dims]; thread tid writes 8-element chunk
    // tid % 16 of rows tid / 16 + 8 k. Rows past T are zeros.
    unsigned char* qw = qs + wg * (kQBytes / 2);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = tid / 16 + 8 * k, cc = tid % 16;
      const int row = wg * 64 + r;
      const int i = i0 + row / a.G;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (i < a.T)
        v = load_q8(a.q,
                    ((static_cast<int64_t>(b) * a.T + i) * a.Hq +
                     h_kv * a.G + row % a.G) * kD + cc * 8,
                    a.q_bf16, a.sm_scale);
      *reinterpret_cast<uint4*>(qw + (cc / 8) * (kQBytes / 4) + r * 128 +
                                (((cc % 8) ^ (r % 8)) * 16)) = v;
    }
    fence_async_smem();
    named_sync(2 + wg, 128);

    // Accumulator layout (64 x 128 per warpgroup): thread holds rows
    // r0 = 16 warp + lane / 4 and r0 + 8; element 4n + c is column
    // 8n + 2 (lane % 4) + (c & 1) of row r0 + 8 (c >> 1).
    float o[64];
#pragma unroll
    for (int n = 0; n < 64; ++n) o[n] = 0.f;
    float m_row[2] = {QT_MASK_VALUE, QT_MASK_VALUE};
    float l_row[2] = {0.f, 0.f};              // this thread's share
    const int r0 = wg * 64 + warp * 16 + lane / 4;
    const int pos[2] = {offset + i0 + r0 / a.G, offset + i0 + (r0 + 8) / a.G};
    const int wg_lo = offset + i0 + (wg * 64) / a.G;       // first position
    const int wg_hi = offset + i0 + (wg * 64 + 63) / a.G;  // last position
    const uint32_t q_base = smem_u32(qw);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int t0 = j * kBK;
      bar_wait(&full[s], (j / kStages) & 1);
      if (t0 <= wg_hi) {                        // a key some row can see
        const uint32_t kb = smem_u32(ring + s * kStage), vb = kb + kTile;
        float sc[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          wgmma_ss(sc,
                   sw128_desc(q_base + (kk / 4) * (kQBytes / 4) + (kk % 4) * 32,
                              16, 1024),
                   sw128_desc(kb + (kk / 4) * kHalf + (kk % 4) * 32, 16, 1024),
                   kk > 0);
        wgmma_commit();
        wgmma_wait_all();

        // Causal and length mask where a key may be past a row's position
        // or past kv_len; masked scores hold exactly the mask value.
        const bool masked = t0 + kBK - 1 > wg_lo || t0 + kBK > kv_len;
        if (masked) {
#pragma unroll
          for (int n = 0; n < 64; ++n) {
            const int k_pos = t0 + 8 * (n / 4) + 2 * (lane % 4) + (n & 1);
            const bool ok = k_pos <= pos[(n >> 1) & 1] && k_pos < kv_len;
            sc[n] = ok ? sc[n] : QT_MASK_VALUE;
          }
        }
        float mx[2] = {m_row[0], m_row[1]};
#pragma unroll
        for (int n = 0; n < 64; ++n)
          mx[(n >> 1) & 1] = fmaxf(mx[(n >> 1) & 1], sc[n]);
        float alpha[2], mb[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          alpha[r] = fast_exp2((m_row[r] - mx[r]) * kLog2e);
          m_row[r] = mx[r];
          l_row[r] *= alpha[r];
          mb[r] = mx[r] * kLog2e;
        }
#pragma unroll
        for (int n = 0; n < 64; ++n) {
          const int r = (n >> 1) & 1;
          float p = fast_exp2(fmaf(sc[n], kLog2e, -mb[r]));
          if (masked) p = sc[n] == QT_MASK_VALUE ? 0.f : p;
          l_row[r] += p;
          sc[n] = p;
          o[n] *= alpha[r];
        }
        // P (rounded to bf16) as the A operand: 16 tokens a step.
        uint32_t pa[kBK / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_rs(o, pa[kk], sw128_desc(vb + kk * 16 * 128, kHalf, 1024));
        wgmma_commit();
        wgmma_wait_all();
      }
      bar_arrive(&empty[s]);                    // the slot may be refilled
    }

    // out[b, i, hq, :] = O / l for the rows inside T.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
      l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const int i = i0 + row / a.G;
      if (i >= a.T) continue;
      const float inv = l_row[r] > 0.f ? 1.f / l_row[r] : 0.f;
      float* dst = a.out + ((static_cast<int64_t>(b) * a.T + i) * a.Hq +
                            h_kv * a.G + row % a.G) * kD + 2 * (lane % 4);
#pragma unroll
      for (int n = 0; n < kD / 8; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// f32 pools: FMA kernel.
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;

// f32 pools: one CTA takes kRF query rows of one head; 32-token K/V
// tiles go through shared memory, each thread computes scores of
// (row, token) pairs with FMAs, one warp runs the online softmax of a
// row, and thread t accumulates output dim t of every row.
constexpr int kRF = 16;              // query rows per CTA
constexpr int kTF = 32;              // tokens per K/V tile (one per lane)
constexpr int kKStrF = kD + 4;       // padded K row: float4 reads of 8
                                     // consecutive rows hit distinct banks

__global__ void __launch_bounds__(kThreads)
prefill_f32_kernel(const void* __restrict__ q, const float* __restrict__ kv,
                   const int* __restrict__ tab,
                   const int* __restrict__ q_offsets,
                   const int* __restrict__ kv_lens, float* __restrict__ out,
                   int T, int Hq, int G, int NP, int page, int NB, int bpp,
                   float sm_scale, int q_bf16) {
  __shared__ __align__(16) float qs[kRF][kD];
  __shared__ __align__(16) float ks[kTF][kKStrF];
  __shared__ __align__(16) float vs[kTF][kD];
  __shared__ float ps[kRF][kTF];
  __shared__ float m_s[kRF], l_s[kRF], alpha_s[kRF];

  const int i0 = blockIdx.x * kRF, hq = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h_kv = hq / G;
  const int offset = q_offsets[b];
  // Keys past the block table do not exist (as in the plain version).
  const int kv_len = min(kv_lens[b], NB * bpp * page);
  const int hi = min(offset + i0 + kRF, kv_len);

  // The scaled query rows (rows past T are zeros and are not written).
  for (int i = tid; i < kRF * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    float x = 0.f;
    if (i0 + r < T) {
      const int64_t at = ((static_cast<int64_t>(b) * T + i0 + r) * Hq + hq) *
                         kD + d;
      x = q_bf16 ? __bfloat162float(static_cast<const bf16*>(q)[at])
                 : static_cast<const float*>(q)[at];
    }
    qs[r][d] = x * sm_scale;
  }
  if (tid < kRF) {
    m_s[tid] = QT_MASK_VALUE;
    l_s[tid] = 0.f;
  }
  float acc[kRF];
#pragma unroll
  for (int r = 0; r < kRF; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < hi; t0 += kTF) {
    // K and V rows, one float4 a thread and step; rows past hi are zeros.
    for (int c = tid; c < kTF * (kD / 4); c += kThreads) {
      const int r = c / (kD / 4), cc = c % (kD / 4);
      const int t = t0 + r;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (t < hi) {
        const int64_t off = kv_row(h_kv, phys_page(tab, b, NB, bpp, t / page),
                                   t % page, NP, page, kD);
        kk = __ldg(reinterpret_cast<const float4*>(kv + off) + cc);
        vv = __ldg(reinterpret_cast<const float4*>(kv + off + page * kD) + cc);
      }
      *reinterpret_cast<float4*>(&ks[r][cc * 4]) = kk;
      *reinterpret_cast<float4*>(&vs[r][cc * 4]) = vv;
    }
    __syncthreads();

    // Scores with the causal and length mask.
    for (int i = tid; i < kRF * kTF; i += kThreads) {
      const int r = i / kTF, j = i % kTF;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < kD / 4; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[j][c * 4]);
        const float4 q4 = *reinterpret_cast<const float4*>(&qs[r][c * 4]);
        s = fmaf(q4.x, k4.x, s);
        s = fmaf(q4.y, k4.y, s);
        s = fmaf(q4.z, k4.z, s);
        s = fmaf(q4.w, k4.w, s);
      }
      const int k_pos = t0 + j;
      const bool ok = k_pos <= offset + i0 + r && k_pos < kv_len;
      ps[r][j] = ok ? s : QT_MASK_VALUE;
    }
    __syncthreads();

    // Online softmax, one warp per row, one token per lane.
    for (int r = warp; r < kRF; r += kThreads / 32) {
      const float s = ps[r][lane];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      // Masked lanes hold exactly the mask value; they contribute 0.
      const float p = s == QT_MASK_VALUE ? 0.f : expf(s - m_new);
      ps[r][lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O += P V: thread tid owns output dim tid of every row.
#pragma unroll
    for (int r = 0; r < kRF; ++r) acc[r] *= alpha_s[r];
    for (int j = 0; j < kTF; ++j) {
      const float v = vs[j][tid];
#pragma unroll
      for (int r = 0; r < kRF; ++r) acc[r] = fmaf(ps[r][j], v, acc[r]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRF; ++r) {
    const int i = i0 + r;
    if (i >= T) continue;
    out[((static_cast<int64_t>(b) * T + i) * Hq + hq) * kD + tid] =
        l_s[r] > 0.f ? acc[r] / l_s[r] : 0.f;
  }
}

template <bool kFp8>
cudaError_t launch_tma(const void* tmap, const TmaArgs& a, int B, int Hkv,
                       cudaStream_t s) {
  const size_t smem = tma_smem<kFp8>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_tma_kernel<kFp8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  CUtensorMap map;                 // by value into the kernel's parameters
  memcpy(&map, tmap, sizeof(map));
  const int P = kM / a.G;
  dim3 grid(Hkv, B, (a.T + P - 1) / P);
  prefill_tma_kernel<kFp8><<<grid, kTmaThreads, smem, s>>>(map, a);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

}  // namespace

// The TMA descriptor of one layer of a bf16 (kv_dtype 1) or fp8 e4m3 (2)
// pool [Hkv, NP, 2, page, 128] seen as `rows` rows of 128 elements: boxes
// of one page by 64 bf16 columns with the 128-byte swizzle wgmma reads,
// or one page by 128 fp8 columns unswizzled (the widening pass reads it).
// Writes the 128-byte CUtensorMap to `out`; returns the CUresult, or -1
// when the driver has no cuTensorMapEncodeTiled.
extern "C" int prefill_tensor_map(void* base, long long rows, int kv_dtype,
                                  int page, void* out) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess ||
        fn == nullptr)
      return -1;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const bool fp8 = kv_dtype == 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kD),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kD * (fp8 ? 1 : 2))};
  const cuuint32_t box[2] = {fp8 ? 128u : 64u, static_cast<cuuint32_t>(page)};
  const cuuint32_t elem_strides[2] = {1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, fp8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, base, dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      fp8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) memcpy(out, &map, sizeof(map));
  return static_cast<int>(r);
}

// kv_dtype: 0 f32 (FMA kernel), 1 bf16, 2 fp8 e4m3 (TMA + wgmma kernel,
// which takes tmap from prefill_tensor_map and G = Hq / Hkv in 1, 2, 4, 8,
// page a multiple of 8 dividing 128; the wrapper checks both).
extern "C" int prefill_launch(const void* q, const void* kv, const int* tab,
                              const int* q_offsets, const int* kv_lens,
                              float* out, int B, int T, int Hq, int Hkv,
                              int NP, int page, int NB, int bpp, int kv_dtype,
                              float sm_scale, int q_bf16, const void* tmap,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0) {
    dim3 grid((T + kRF - 1) / kRF, Hq, B);
    prefill_f32_kernel<<<grid, kThreads, 0, s>>>(
        q, static_cast<const float*>(kv), tab, q_offsets, kv_lens, out, T, Hq,
        Hq / Hkv, NP, page, NB, bpp, sm_scale, q_bf16);
    return static_cast<int>(cudaGetLastError());
  }
  const int G = Hq / Hkv;
  if ((kv_dtype != 1 && kv_dtype != 2) || tmap == nullptr ||
      (G != 1 && G != 2 && G != 4 && G != 8) || page % 8 != 0 ||
      kBK % page != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const TmaArgs a{q,    tab, q_offsets, kv_lens, out,
                  T,    Hq,  G,         NP,      page,
                  NB,   bpp, Hkv * NP * 2 * page, sm_scale, q_bf16};
  return static_cast<int>(kv_dtype == 2 ? launch_tma<true>(tmap, a, B, Hkv, s)
                                        : launch_tma<false>(tmap, a, B, Hkv, s));
}
