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
// tensor cores. The un-scaled q (bf16 or f32) is multiplied by the
// softmax scale in f32 and rounded to bf16 as it is loaded, as the JAX
// wrapper does before its kernel. The design keeps the tensor cores
// fed the way FlashAttention-2 does, with warp-level MMA (mma.sync
// m16n8k16, bf16 in, f32 accumulate): one CTA of 4 warps takes 64
// query rows of one head (16 a warp, held as MMA fragments in
// registers); 64-token K/V tiles stream through two shared-memory
// buffers with cp.async, the next tile loading while the current one
// is multiplied; S = Q K^T, the online softmax and O += P V all stay in
// registers (the S accumulators are re-packed as the bf16 A operand of
// the PV product, which is where p is rounded to bf16 as the JAX kernel
// rounds it).
// Tiles past the causal bound of the CTA's last row are never loaded.
// Left for later: wgmma/TMA, and sharing a K/V tile across the G query
// heads of a group.
//
// f32 pools (off the serving path, which keeps bf16 KV) take a plain
// FMA kernel, prefill_f32_kernel: the contract there is f32 products
// throughout, which bf16 tensor cores cannot keep.
//
// fp8 e4m3 pools (the serving configuration's capacity option) take the
// MMA kernel too: each fp8 K/V tile arrives by cp.async in one of two
// staging buffers (half the bytes of a bf16 tile), and the CTA converts
// it with the upcast_fp8 recipe (common.cuh) into the one bf16 tile the
// MMA fragments read, before the products. The staging buffers carry the
// double buffering, so the bf16 tile needs no second copy and the CTA
// fits in 83 KB of shared memory, two CTAs an SM as in bf16. The JAX
// kernel upcasts the same way, so q and p stay bf16. Overlapping the
// conversion with the MMAs is left for later.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 128;
constexpr int kBQ = 64;              // query rows per CTA
constexpr int kBK = 64;              // tokens per K/V tile
constexpr int kThreads = 128;        // 4 warps x 16 query rows
constexpr int kStride = kD + 8;      // padded smem row: ldmatrix rows of
                                     // one 8x8 matrix hit distinct banks
constexpr int kCPR = kD / 8;         // 16-byte chunks per row
constexpr int kTile = kBK * kStride; // elements of one K or V buffer
constexpr size_t kStage = kBK * kD;  // bytes of one fp8 K or V tile

// Shared memory of the MMA kernel: the Q tile, K and V tiles (two of
// each for bf16, one each for fp8), and for fp8 two staging buffers of
// [K tile, V tile].
template <typename KV>
constexpr size_t mma_smem() {
  return sizeof(KV) == 1
             ? (kBQ * kStride + 2 * kTile) * sizeof(bf16) + 4 * kStage
             : (kBQ * kStride + 4 * kTile) * sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; a false predicate zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16x8] += a[16x16] * b[16x8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// KV: the pool's element type, bf16 or fp8 e4m3.
template <typename KV>
__global__ void __launch_bounds__(kThreads)
prefill_kernel(const void* __restrict__ q, const KV* __restrict__ kv,
               const int* __restrict__ tab, const int* __restrict__ q_offsets,
               const int* __restrict__ kv_lens, float* __restrict__ out,
               int T, int Hq, int G, int NP, int page, int NB, int bpp,
               float sm_scale, int q_bf16) {
  constexpr bool kFp8 = sizeof(KV) == 1;
  constexpr int CH = 16 / sizeof(KV);   // pool elements per 16-byte chunk
  constexpr int CPR = kD / CH;         // chunks per pool row
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kBQ * kStride;       // two K buffers, then two V buffers
  constexpr int kBufs = kFp8 ? 1 : 2;  // bf16 K (and V) tiles
  bf16* vs = ks + kBufs * kTile;
  // fp8 only: two staging buffers of [K tile, V tile], unpadded rows.
  unsigned char* stage = reinterpret_cast<unsigned char*>(vs + kBufs * kTile);

  // Heaviest (latest) query tiles first: they stream the most K/V.
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // MMA fragment row / column pair
  const int h_kv = hq / G;
  const int offset = q_offsets[b];
  const int kv_len = kv_lens[b];
  const int max_tok = NB * bpp * page;
  const int hi = min(offset + i0 + kBQ, kv_len);
  const int n_tiles = hi > 0 ? (hi + kBK - 1) / kBK : 0;

  // Each thread copies chunk column tid % CPR of rows tid / CPR + k * i:
  // bf16 rows straight into the MMA tiles, fp8 rows into staging.
  const int pc = tid % CPR, pr = tid / CPR;
  auto load_tile = [&](int j, int buf) {
#pragma unroll
    for (int i = 0; i < kBK / (kThreads / CPR); ++i) {
      const int r = pr + i * (kThreads / CPR);
      const int t = j * kBK + r;
      const bool ok = t < max_tok;
      int64_t off = 0;
      if (ok)
        off = kv_row(h_kv, phys_page(tab, b, NB, bpp, t / page), t % page, NP,
                     page, kD);
      const KV* src = kv + off + pc * CH;
      if constexpr (kFp8) {
        unsigned char* dst = stage + (2 * buf) * kStage + r * kD + pc * CH;
        cp_async16(dst, src, ok);
        cp_async16(dst + kStage, src + page * kD, ok);
      } else {
        cp_async16(ks + buf * kTile + r * kStride + pc * CH, src, ok);
        cp_async16(vs + buf * kTile + r * kStride + pc * CH, src + page * kD,
                   ok);
      }
    }
  };
  // fp8: the staged tiles of buffer buf as the bf16 MMA tiles, 16 fp8 values
  // (one 16-byte chunk) a thread and step.
  auto convert_tile = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2 * kBK / (kThreads / 8); ++i) {
      const int row = tid / 8 + i * (kThreads / 8);   // 0..127: K, then V
      const int r = row % kBK, c = tid % 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          stage + (2 * buf + row / kBK) * kStage + r * kD + c * 16);
      store_tile_chunk<KV>(
          (row < kBK ? ks : vs) + r * kStride + c * 16, raw);
    }
  };

  // The first K/V tile in flight, then the scaled Q tile (rows past T
  // are zeros); thread tid writes chunk tid % 16 of rows tid / 16 + 8 i.
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  const int cc = tid % kCPR;
#pragma unroll
  for (int i = 0; i < kBQ / (kThreads / kCPR); ++i) {
    const int r = tid / kCPR + i * (kThreads / kCPR);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (i0 + r < T)
      val = load_q8(q, ((static_cast<int64_t>(b) * T + i0 + r) * Hq + hq) * kD +
                           cc * 8, q_bf16, sm_scale);
    *reinterpret_cast<uint4*>(qs + r * kStride + cc * 8) = val;
  }

  // This warp's 16 query rows as A fragments, one per 16-dim step.
  __syncthreads();
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kStride + kk * 16 +
                            (lane >> 4) * 8);

  float o[kD / 8][4];                   // output rows g, g+8; 16 dim blocks
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_row[2] = {QT_MASK_VALUE, QT_MASK_VALUE};
  float l_row[2] = {0.f, 0.f};          // this thread's share of the sums
  const int q_pos0 = offset + i0 + warp * 16 + g;  // row g; row g+8 is +8

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) load_tile(j + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();                 // tile j has landed (this thread)
    __syncthreads();                    // ... and every thread's part of it
    if constexpr (kFp8) {
      convert_tile(buf);
      __syncthreads();
    }
    const bf16* kt = ks + (kFp8 ? 0 : buf) * kTile;
    const bf16* vt = vs + (kFp8 ? 0 : buf) * kTile;

    // S = Q K^T: 16 rows x 64 tokens as 8 accumulator blocks of 8 tokens.
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kBK / 8; n += 2) {
        // Matrices: tokens n*8.. (dims lo, hi), tokens n*8+8.. (lo, hi).
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (n * 8 + (lane & 7) + (lane >> 4) * 8) * kStride +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[n], qf[kk], kb[0], kb[1]);
        mma_bf16(s[n + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // Mask, online softmax; rows g (c = 0, 1) and g + 8 (c = 2, 3).
    float mx[2] = {QT_MASK_VALUE, QT_MASK_VALUE};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k_pos = j * kBK + n * 8 + 2 * t4 + (c & 1);
        const int q_pos = q_pos0 + (c >> 1) * 8;
        const bool ok = k_pos <= q_pos && k_pos < kv_len;
        s[n][c] = ok ? s[n][c] : QT_MASK_VALUE;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r]);
      alpha[r] = expf(m_row[r] - m_new);
      m_row[r] = m_new;
      l_row[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // Masked lanes hold exactly the mask value; they contribute 0.
        const float p = s[n][c] == QT_MASK_VALUE
                            ? 0.f : expf(s[n][c] - m_row[c >> 1]);
        l_row[c >> 1] += p;
        s[n][c] = p;
      }
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P (rounded to bf16) as A fragments of 16 tokens each.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                        pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                        pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                        pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < kD / 8; n += 2) {
        // Matrices (transposed): tokens lo/hi x dims n*8.., n*8+8...
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * kStride +
                                  n * 8 + (lane >> 4) * 8);
        mma_bf16(o[n], pa, vb[0], vb[1]);
        mma_bf16(o[n + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();                    // buffer `buf` is free again
  }

  // out[b, i, hq, :] = O / l for the real rows.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 1);
    l_row[r] += __shfl_xor_sync(0xffffffffu, l_row[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + warp * 16 + g + r * 8;
    if (i >= T) continue;
    const float inv = l_row[r] > 0.f ? 1.f / l_row[r] : 0.f;
    float* dst = out + ((static_cast<int64_t>(b) * T + i) * Hq + hq) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + 2 * t4) =
          make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

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
  const int kv_len = kv_lens[b];
  const int hi = min(min(offset + i0 + kRF, kv_len), NB * bpp * page);

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

template <typename KV>
cudaError_t launch_mma(const void* q, const void* kv, const int* tab,
                       const int* q_offsets, const int* kv_lens, float* out,
                       int B, int T, int Hq, int Hkv, int NP, int page,
                       int NB, int bpp, float sm_scale, int q_bf16,
                       cudaStream_t s) {
  const size_t smem = mma_smem<KV>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((T + kBQ - 1) / kBQ, Hq, B);
  prefill_kernel<KV><<<grid, kThreads, smem, s>>>(
      q, static_cast<const KV*>(kv), tab, q_offsets, kv_lens, out, T, Hq,
      Hq / Hkv, NP, page, NB, bpp, sm_scale, q_bf16);
  return cudaGetLastError();
}

}  // namespace

// kv_dtype: 0 f32 (FMA kernel), 1 bf16, 2 fp8 e4m3 (MMA kernel).
extern "C" int prefill_launch(const void* q, const void* kv, const int* tab,
                              const int* q_offsets, const int* kv_lens,
                              float* out, int B, int T, int Hq, int Hkv,
                              int NP, int page, int NB, int bpp, int kv_dtype,
                              float sm_scale, int q_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 0) {
    dim3 grid((T + kRF - 1) / kRF, Hq, B);
    prefill_f32_kernel<<<grid, kThreads, 0, s>>>(
        q, static_cast<const float*>(kv), tab, q_offsets, kv_lens, out, T, Hq,
        Hq / Hkv, NP, page, NB, bpp, sm_scale, q_bf16);
    return static_cast<int>(cudaGetLastError());
  }
  if (kv_dtype == 1)
    return static_cast<int>(launch_mma<bf16>(q, kv, tab, q_offsets, kv_lens,
                                              out, B, T, Hq, Hkv, NP, page, NB,
                                              bpp, sm_scale, q_bf16, s));
  if (kv_dtype == 2)
    return static_cast<int>(launch_mma<__nv_fp8_e4m3>(
        q, kv, tab, q_offsets, kv_lens, out, B, T, Hq, Hkv, NP, page, NB, bpp,
        sm_scale, q_bf16, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
