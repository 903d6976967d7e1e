// Weight-only quantized products: the decode rows' product with int8 or
// int4 weights (qgemv), and the dequantization of one layer's weights for
// the prefill rows' product (dequant).
//
// Neither has a Pallas counterpart. They replace XLA's fusion of
// quest_tpu/models/quantize.py:qdot (line 84), where the cast and the
// scale of the packed weights feed the dot's operand read, so the weights
// stream from device memory at their packed width. PyTorch's eager ops do
// not fuse: (q.float() * s).to(bf16) @ x moves more bytes than bf16
// weights would.
//
// Layout, as the JAX package stores it: q int8 [in, out] (int8), or
// [in/2, out] (int4, block split: row r's low nibble is input row r, its
// high nibble input row r + in/2); s f32 [out]; inv_s f32 [in] (the AWQ
// fold, optional). The activation is folded as (dtype)(x * (dtype)inv_s)
// while it is staged, as JAX does; products accumulate in f32.
//
// qgemv, x [M <= 16, in] (bf16 or f32) -> out [M, out] in x's dtype.
// Bound on the H100: bytes, the packed weights read once (58.7 MB for
// Llama-3.1-8B's w_gate in int8, 29.4 MB in int4, against 3.35 TB/s);
// every weight is also unpacked on its own, a few integer and float
// operations each, so the issue rate is the other limit, and int4 (twice
// the weights a byte) meets it first. Two kernels:
// - bf16 x (every decode step of a bf16 model): qgemv_ring_kernel. A
//   producer warp streams q through a shared-memory ring by TMA (2-D
//   boxes of a stage's rows x 64 columns, the 64-byte swizzle), so the
//   loads of later stages overlap the unpacking of earlier ones and no
//   register holds a prefetch; 8 consumer warps stage the split's x once
//   and unpack each weight straight into a tensor-core fragment
//   (mma.sync m16n8k16, f32 accumulation). The per-column scale
//   is applied once, after the sum: out = s * (x . q), with q exact in
//   bf16 (int8 through f32, int4 by the 0x4300 bf16 mantissa trick), 2.5
//   (int8) or 1.5 (int4) operations a weight. JAX rounds every
//   (bf16)(float(q) * s) instead; -DQT_QGEMV_SCALE_EACH builds that order
//   (ROADMAP queue 3 o has the difference). The input rows of a column
//   tile are split over the CTAs of one thread-block cluster, which merge
//   their partials through distributed shared memory: no global partial,
//   no ticket.
// - f32 x (the f32 lm_head product, f32 models): qgemv_kernel, FMA in
//   f32, ~7 operations a weight at M = 2, the M-row FMAs on top. A CTA
//   owns a tile of 256 columns and a split of the input rows; a thread's
//   load is 16 bytes of a q row, the next loads in flight while it works
//   on the current ones; the last CTA of a column tile to take a ticket
//   adds the f32 partials in split order and resets the ticket to zero.
//   It also takes bf16 x whose out is not a multiple of 16 (TMA needs
//   16-byte row strides, so the ring kernel cannot read such a q): the
//   folded x and each weight rounded to bf16 as JAX rounds them, f32
//   sums, out rounded once. Rows of q that are not 16-byte aligned are
//   read a byte at a time, and the last tile's columns past out are
//   masked.
// The plans (ops/qdot.py:qgemv_plan) are pure functions of the shapes and
// the SM count.
//
// dequant, q -> w [in, out] in bf16 or f32, bitwise equal to
// dequantize_weight: (dtype)(float(q) * s[j] [* inv_s[i]]). Bound: bytes,
// q read once and w written once. An out whose rows its vector loads and
// stores cannot align takes dequant_any_kernel, an element a thread.
#include <cooperative_groups.h>
#include <string.h>

#include "mma.cuh"
#include "tensor_map.cuh"

namespace cg = cooperative_groups;

namespace qt {

constexpr int kQThreads = 256;
constexpr int kQCols = 16;                     // columns a thread
constexpr int kQColThreads = 16;               // threads across a tile
constexpr int kQTileN = kQCols * kQColThreads;  // 256 columns a CTA

// Four signed bytes as exact floats: b + 128 is put in the mantissa of
// 2^23 (0x4B0000xx) and 2^23 + 128 is taken off again.
__device__ __forceinline__ void s8x4_to_float(unsigned w, float* f) {
  const unsigned u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.f;
}

// The low and high nibbles of four bytes, sign-extended, as exact floats
// (n ^ 8 is the nibble's signed value plus 8).
__device__ __forceinline__ void s4x8_to_float(unsigned w, float* lo,
                                              float* hi) {
  const unsigned l = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const unsigned h = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lo[i] = __uint_as_float(__byte_perm(l, 0x4B000000u, 0x7440 + i)) -
            8388616.f;
    hi[i] = __uint_as_float(__byte_perm(h, 0x4B000000u, 0x7440 + i)) -
            8388616.f;
  }
}

template <typename T>
__device__ __forceinline__ void store_f(T* p, float v) {
  if constexpr (sizeof(T) == 2) *p = __float2bfloat16_rn(v);
  else *p = v;
}

// The ticket merge, after a CTA stored its partial for rows [0, M) of the
// ``tile_n``-column tile at n0: the last CTA of the tile to take a ticket
// adds every split's partial, in split order (a batch of splits' loads
// issued together), writes out (times ``scale[n]`` when given) and
// leaves the ticket at zero. Every thread of the CTA calls it;
// ``is_last`` is a shared int of the caller's.
template <typename T>
__device__ __forceinline__ void split_merge(T* out, const float* part,
                                            int* tickets,
                                            const float* scale, int M,
                                            int N, int n0, int tile_n,
                                            int tile, int ksplit,
                                            int& is_last) {
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // the CTA's partials (ordered by the barrier) first
    is_last = atomicAdd(&tickets[tile], 1) == ksplit - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (tid == 0) tickets[tile] = 0;  // zero for the next launch
  constexpr int kBatch = 8;
  const int64_t stride = static_cast<int64_t>(M) * N;
  for (int i = tid; i < M * tile_n; i += blockDim.x) {
    const int m = i / tile_n, n = n0 + i % tile_n;
    if (n >= N) continue;
    const float* p = part + static_cast<int64_t>(m) * N + n;
    float v = 0.f;
    for (int s0 = 0; s0 < ksplit; s0 += kBatch) {
      float b[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        b[u] = s0 + u < ksplit ? __ldcg(p + (s0 + u) * stride) : 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v += b[u];
    }
    store_f(out + static_cast<int64_t>(m) * N + n,
            scale != nullptr ? scale[n] * v : v);
  }
}

// x [M, K] row-major; q one layer [Kq, N] (Kq = K, or K / 2 for int4);
// s [N]; inv_s [K] or null; out [M, N]; part [ksplit, M, N] f32 and
// tickets [tiles] (zero between launches) when ksplit > 1. Grid (tiles,
// ksplit); CTA (tile, split) takes q rows [split * chunk, + chunk), whose
// x slice it stages in dynamic shared memory once (ops/qdot.py:qgemv_plan
// keeps it within 48 KB). MR rows of x a thread group, MG groups:
// M <= MR * MG: rows of x beyond 4 are taken by groups of threads that
// read the same q bytes in the same instruction (one load, broadcast), so
// a thread's accumulators stay at 4 x 16 (the groups repeat the
// unpacking). Each thread keeps U loads of q in flight while it works on
// the previous U rows.
// 16 bytes of q at p, of which `valid` (1..16) lie inside the row; p is
// `al`-byte aligned (al = 16, 8, 4, 2 or 1). Whole pieces of min(al, 8)
// bytes load at once (one 16-byte load where the row allows), the bytes
// left past them one at a time; zeros past the row.
__device__ __forceinline__ uint4 ld_q16(const int8_t* p, int al,
                                        int valid) {
  if (al == 16 && valid >= 16)
    return __ldcs(reinterpret_cast<const uint4*>(p));
  unsigned w[4] = {0u, 0u, 0u, 0u};
  int done = 0;
  if (al >= 8) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (8 * i + 8 <= valid) {
        const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p + 8 * i));
        w[2 * i] = v.x;
        w[2 * i + 1] = v.y;
        done = 8 * i + 8;
      }
  } else if (al == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * i + 4 <= valid) {
        w[i] = __ldcs(reinterpret_cast<const unsigned*>(p + 4 * i));
        done = 4 * i + 4;
      }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i >= done && i < valid)
      w[i / 4] |= static_cast<unsigned>(static_cast<uint8_t>(__ldg(p + i)))
                  << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// XT: x's and out's dtype, f32 or bf16.
template <int BITS, int MR, int MG, typename XT>
__global__ void __launch_bounds__(kQThreads, 2)
qgemv_kernel(const XT* __restrict__ x, const int8_t* __restrict__ q,
             const float* __restrict__ s, const float* __restrict__ inv_s,
             XT* __restrict__ out, float* __restrict__ part,
             int* __restrict__ tickets, int M, int K, int N, int chunk,
             int ksplit) {
  const auto rnd = [](float v) {  // JAX's rounding to x's dtype
    if constexpr (sizeof(XT) == 2)
      return __bfloat162float(__float2bfloat16_rn(v));
    else
      return v;
  };
  constexpr int kH = BITS == 4 ? 2 : 1;          // x halves a q row feeds
  constexpr int kMT = MR * MG;
  constexpr int kRL = kQThreads / (kQColThreads * MG);  // row lanes
  constexpr int kU = MR <= 2 ? 4 : 2;            // loads in flight
  extern __shared__ __align__(16) float sm[];    // x slice, then partials
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int c = tid % kQColThreads;
  const int g = (tid / kQColThreads) % MG;
  const int r = tid / (kQColThreads * MG);
  const int Kq = BITS == 4 ? K / 2 : K;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int n0 = tile * kQTileN;
  const int col = n0 + c * kQCols;
  const bool col_ok = col < N;
  const bool vec = N % kQCols == 0;   // every row 16-byte aligned and whole
  // The widest piece every row's q allows: its address and N both
  // multiples of al.
  const unsigned lo = static_cast<unsigned>(reinterpret_cast<uintptr_t>(q)) |
                      static_cast<unsigned>(N) | 16u;
  const int al = static_cast<int>(lo & (0u - lo));
  const int ncol = N - col;           // the thread's columns inside out
  const int kbeg = split * chunk;
  const int nrow = min(Kq, kbeg + chunk) - kbeg;

  float sc[kQCols];
#pragma unroll
  for (int i = 0; i < kQCols; i += 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (col_ok && vec) {
      v = __ldg(reinterpret_cast<const float4*>(s + col + i));
    } else if (col_ok) {
      v.x = i < ncol ? s[col + i] : 0.f;
      v.y = i + 1 < ncol ? s[col + i + 1] : 0.f;
      v.z = i + 2 < ncol ? s[col + i + 2] : 0.f;
      v.w = i + 3 < ncol ? s[col + i + 3] : 0.f;
    }
    sc[i] = v.x;
    sc[i + 1] = v.y;
    sc[i + 2] = v.z;
    sc[i + 3] = v.w;
  }
  float acc[MR][kQCols];
#pragma unroll
  for (int j = 0; j < MR; ++j)
#pragma unroll
    for (int e = 0; e < kQCols; ++e) acc[j][e] = 0.f;

  const int8_t* qb = q + static_cast<int64_t>(kbeg) * N + col;
  uint4 cur[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int kk = r + u * kRL;
    cur[u] = (col_ok && kk < nrow)
                 ? ld_q16(qb + static_cast<int64_t>(kk) * N, al, ncol)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  // Stage x[:, kbeg:kbeg+nrow] (and the high half's rows for int4),
  // folded by inv_s and rounded to T as JAX does; rows past M are zero.
  for (int i = tid; i < kMT * kH * nrow; i += kQThreads) {
    const int kk = i % nrow, h = (i / nrow) % kH, m = i / (nrow * kH);
    float v = 0.f;
    if (m < M) {
      const int k = kbeg + kk + h * Kq;
      v = static_cast<float>(x[static_cast<int64_t>(m) * K + k]);
      if (inv_s != nullptr) v = rnd(v * rnd(inv_s[k]));
    }
    sm[i] = v;
  }

  __syncthreads();  // the x slice is staged
  for (int k0 = r; k0 < nrow; k0 += kU * kRL) {
    uint4 nxt[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = k0 + (kU + u) * kRL;
      nxt[u] = (col_ok && kk < nrow)
                   ? ld_q16(qb + static_cast<int64_t>(kk) * N, al, ncol)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = k0 + u * kRL;
      if (kk >= nrow) break;
      float xv[MR][kH];
#pragma unroll
      for (int j = 0; j < MR; ++j)
#pragma unroll
        for (int h = 0; h < kH; ++h)
          xv[j][h] = sm[((g * MR + j) * kH + h) * nrow + kk];
      const unsigned wd[4] = {cur[u].x, cur[u].y, cur[u].z, cur[u].w};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        if constexpr (BITS == 8) {
          float w[4];
          s8x4_to_float(wd[wi], w);
#pragma unroll
          for (int e = 0; e < 4; ++e) w[e] = rnd(w[e] * sc[wi * 4 + e]);
#pragma unroll
          for (int j = 0; j < MR; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[j][wi * 4 + e] = fmaf(xv[j][0], w[e], acc[j][wi * 4 + e]);
        } else {
          float lo[4], hi[4];
          s4x8_to_float(wd[wi], lo, hi);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            lo[e] = rnd(lo[e] * sc[wi * 4 + e]);
            hi[e] = rnd(hi[e] * sc[wi * 4 + e]);
          }
#pragma unroll
          for (int j = 0; j < MR; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float a = acc[j][wi * 4 + e];
              a = fmaf(xv[j][0], lo[e], a);
              acc[j][wi * 4 + e] = fmaf(xv[j][1], hi[e], a);
            }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
  }

  // Sum the row lanes of each (row of x, column) through shared memory,
  // one row of x of each group at a time.
#pragma unroll
  for (int j = 0; j < MR; ++j) {
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(
        sm + (g * kRL + r) * kQTileN + c * kQCols);
#pragma unroll
    for (int e = 0; e < kQCols; e += 4)
      dst[e / 4] = make_float4(acc[j][e], acc[j][e + 1], acc[j][e + 2],
                               acc[j][e + 3]);
    __syncthreads();
    for (int i = tid; i < MG * kQTileN; i += kQThreads) {
      const int gg = i / kQTileN, cc = i % kQTileN;
      const int m = gg * MR + j, n = n0 + cc;
      if (m >= M || n >= N) continue;
      float v = 0.f;
#pragma unroll
      for (int rr = 0; rr < kRL; ++rr) v += sm[(gg * kRL + rr) * kQTileN + cc];
      if (ksplit == 1)
        store_f(out + static_cast<int64_t>(m) * N + n, v);
      else
        part[(static_cast<int64_t>(split) * M + m) * N + n] = v;
    }
  }
  if (ksplit == 1) return;

  split_merge(out, part, tickets, static_cast<const float*>(nullptr), M, N,
              n0, kQTileN, tile, ksplit, is_last);
}

// ---------------------------------------------------------------------------
// bf16 activations: qgemv_ring_kernel.
//
// A CTA owns a tile of tile_n (64, 128 or 256) output columns and a split
// of `chunk` q rows; the ksplit CTAs of a tile are one cluster (grid
// (ksplit, tiles), cluster (ksplit, 1, 1), ksplit <= 8).
// - x: the split's slice of x (and the high half's rows for int4) is
//   staged once by the consumers, [kH][M][chunk + 16] bf16 (the pad puts
//   x's rows 32 bytes apart modulo 128: conflict-free B reads), folded by
//   inv_s as JAX rounds it and each 16-row block in the mma's k order
//   (below); rows past the split are zero. Plain loads, not bulk copies:
//   the TMA unit takes a fixed time a copy (~0.3 us on the card), and
//   the ring's boxes go first. (Streaming x's rows through the ring with
//   each stage cost more than it saved on the card: PERF.md.)
// - Ring: `stages` stages of 16 KB, each br = 16384 / tile_n q rows of
//   the tile as one TMA box of br rows x 64 columns a column group (one
//   tensor map a layer and tile, which ops/qdot.py caches; 64-byte
//   swizzle). A copy costs the TMA unit a fixed time whatever its size,
//   so a stage takes as few as it can. Lane 0 of the producer warp
//   (warp 8) fills slot i % stages with stage i once the slot's `empty`
//   barrier shows the consumers released stage i - stages; the bytes
//   complete on the slot's `full` barrier. Boxes past q's last row or
//   column are zero-filled by TMA (and still count their bytes).
// - Consumers: warp w takes column group w % (tile_n / 64) and, in every
//   stage, the 16-row blocks w / (tile_n / 64) + j * (8 / (tile_n / 64))
//   (two blocks a stage whatever the tile). In a block, lane (g, t) reads
//   8 bytes (8 columns) of rows t, t + 4, t + 8, t + 12: the mma's k index
//   2t + i stands for row t + 4i, 2t + 8 + i for row t + 8 + 4i, and in
//   the c-th of 4 mma instructions its A row g stands for column
//   8 cg(g) + c, row g + 8 for column 8 cg(g) + c + 4. cg(g) permutes the
//   8-byte column units so that, with the 64-byte swizzle, each
//   half-warp's 8-byte reads hit 16 different bank pairs. The B fragments
//   are x's rows at the same k order: position 4 (r % 4) + r / 4 of a
//   staged 16-row block holds its row r. Each warp loads its blocks' A
//   words and B fragments into registers and releases the slot before it
//   unpacks them; x's rows past the split are zero, so a stage's rows of
//   the next split add nothing.
// - Merge: the warps' accumulators are summed through shared memory (over
//   the ring); with ksplit > 1 each CTA stores its partial of column cl
//   into the receive slots of cluster rank cl % ksplit (distributed shared
//   memory, after the cluster barrier's first phase shows every peer has
//   started), and after one cluster barrier each rank adds its slots in
//   split order and writes out = s * sum. Every thread reaches both
//   cluster barrier phases: nothing returns early.
// Ablation builds (exp/qgemv_ablation.py): QT_QGEMV_SCALE_EACH (JAX's
// per-weight scale and rounding), QT_QGEMV_TICKET_MERGE (no cluster: the
// global partials and tickets of split_merge), QT_QGEMV_NO_LOAD (no TMA;
// the consumers read whatever the ring holds), QT_QGEMV_NO_MATH
// (no unpacking or mma: one add a block), QT_QGEMV_NO_MERGE (each CTA
// writes its own partial: wrong, timing only), QT_QGEMV_NO_RING (no ring
// barrier waits or arrivals: with NO_LOAD and NO_MATH, the launch, the
// staging of x and the epilogue alone).
constexpr int kRingWarps = 8;                          // consumer warps
constexpr int kRingThreads = (kRingWarps + 1) * 32;    // + the producer
constexpr int kBoxCols = 64;              // a TMA box: 64 columns by a
constexpr int kStageBytes = 16384;        // stage's 16384 / tile_n rows
constexpr int kMaxStages = 12;
constexpr int kMaxCluster = 8;
// Dynamic shared memory a CTA may take: 227 KB less its static part
// (barriers, the tile's scales) with room to spare.
constexpr int kRingDynamicMax = 232448 - 2048;
// 16-row blocks a consumer warp takes from each stage, whatever the tile.
constexpr int kWarpBlocks = kStageBytes / (16 * kBoxCols * kRingWarps);

// Shared memory of one CTA (host and device agree): 1 KB of alignment
// slack, the ring, the staged x and the receive slots
// [ksplit][M][ceil(tile_n / ksplit)] f32.
__host__ __device__ constexpr int ring_x_pitch(int chunk) { return chunk + 16; }

__host__ __device__ inline size_t ring_smem(int bits, int M, int chunk,
                                            int ksplit, int tile_n,
                                            int stages) {
  const size_t xs = static_cast<size_t>(bits == 4 ? 2 : 1) * M *
                    ring_x_pitch(chunk) * 2;
  const size_t per = (tile_n + ksplit - 1) / ksplit;
  const size_t recv = ksplit > 1 ? static_cast<size_t>(ksplit) * M * per * 4
                                 : 0;
  return 1024 + static_cast<size_t>(stages) * kStageBytes +
         ((xs + 15) & ~size_t(15)) + recv;
}

// Byte c of two words (rows k and k + 1 of a column), signed, as a bf16
// pair (row k low): exact through f32 (2^23 + u, u = b + 128, minus
// 2^23 + 128; an integer of at most 8 significant bits is its f32's upper
// half), or each times its column's scale and rounded, as JAX rounds it.
// The words are XORed with 0x80808080 already.
__device__ __forceinline__ uint32_t s8_pair(unsigned a, unsigned b, int c,
                                            float scale) {
  const float fa =
      __uint_as_float(__byte_perm(a, 0x4B000000u, 0x7440 + c)) - 8388736.f;
  const float fb =
      __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440 + c)) - 8388736.f;
#ifdef QT_QGEMV_SCALE_EACH
  return pack_bf16(fa * scale, fb * scale);
#else
  (void)scale;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
#endif
}

// Byte c of two words (rows k and k + 1), XORed with 0x88888888 already
// (each nibble n ^ 8 = its signed value + 8): the low nibbles and the high
// nibbles as bf16 pairs. Exact: n ^ 8 is put in the mantissa of 128
// (0x4300) and 136 taken off in bf16; or through f32, each times its
// column's scale and rounded, as JAX rounds it.
__device__ __forceinline__ void s4_pair(unsigned a, unsigned b, int c,
                                        float scale, uint32_t& lo,
                                        uint32_t& hi) {
  const unsigned p =
      __byte_perm(a, b, c | (c << 4) | ((c + 4) << 8) | ((c + 4) << 12));
#ifdef QT_QGEMV_SCALE_EACH
  auto f = [&](unsigned v, int byte) {
    return (__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 + byte)) -
            8388616.f) * scale;
  };
  const unsigned l = p & 0x000F000Fu, h = (p >> 4) & 0x000F000Fu;
  lo = pack_bf16(f(l, 0), f(l, 2));
  hi = pack_bf16(f(h, 0), f(h, 2));
#else
  (void)scale;
  const unsigned l = (p & 0x000F000Fu) | 0x43004300u;
  const unsigned h = ((p >> 4) & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 bias = __halves2bfloat162(
      __ushort_as_bfloat16(0x4308), __ushort_as_bfloat16(0x4308));
  const __nv_bfloat162 vl =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), bias);
  const __nv_bfloat162 vh =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h), bias);
  lo = *reinterpret_cast<const uint32_t*>(&vl);
  hi = *reinterpret_cast<const uint32_t*>(&vh);
#endif
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kRingWarps * 32) : "memory");
}

// x [M, K] bf16; q one layer [Kq, N] through qmap; s [N]; inv_s [K] or
// null; out [M, N] bf16. part and tickets: the ticket-merge ablation
// only.
template <int BITS, int MT>
__global__ void __launch_bounds__(kRingThreads, 2)
qgemv_ring_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __nv_bfloat16* __restrict__ x,
                  const float* __restrict__ s,
                  const float* __restrict__ inv_s,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                  int* __restrict__ tickets, int M, int K, int N, int chunk,
                  int tile_n, int stages) {
  constexpr int kH = BITS == 4 ? 2 : 1;
  constexpr int kSets = MT / 8;        // mma sets: x rows 0-7, 8-15
  extern __shared__ unsigned char smraw[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ float s_tile[256];        // the tile's column scales
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int Kq = BITS == 4 ? K / 2 : K;
  const int split = blockIdx.x, tile = blockIdx.y, ksplit = gridDim.x;
  const int n0 = tile * tile_n;
  const int nwc = tile_n / kBoxCols;              // column groups
  const int nwk = kRingWarps / nwc;               // warps a column group
  const int br = kStageBytes / tile_n;            // q rows a stage
  const int kbeg = split * chunk;
  const int nrow = max(0, min(Kq, kbeg + chunk) - kbeg);
  const int nst = (nrow + br - 1) / br;
  const int P = ring_x_pitch(chunk);

  unsigned char* ring =
      smraw + ((1024 - (smem_u32(smraw) & 1023)) & 1023);
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(ring + stages * kStageBytes);
  float* recv = reinterpret_cast<float*>(
      ring + stages * kStageBytes +
      ((static_cast<size_t>(kH) * M * P * 2 + 15) & ~size_t(15)));
  // After the loop the warps' sums take the ring and the staged x:
  // red[kw][m][rs], rows padded by one float (2-way bank conflicts on
  // the stores, not 8-way); 2080 M bytes at most, within them.
  float* red = reinterpret_cast<float*>(ring);
  const int rs = tile_n + 1;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], kRingWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();
#ifndef QT_QGEMV_TICKET_MERGE
  if (ksplit > 1) cluster_arrive_relaxed();  // this CTA's smem is live
#endif

  // acc[set][c]: D rows g, g + 8 (columns 8 cg + c, + 4) by x rows
  // 8 set + 2 t, + 1.
  float acc[kSets][4][4];
#pragma unroll
  for (int st = 0; st < kSets; ++st)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[st][c][e] = 0.f;
  const int g = lane / 4, t = lane % 4;
  const int cgp = (g & 1) | ((g >> 2) << 1) | (((g >> 1) & 1) << 2);
  const int cw = warp % nwc, kw = warp / nwc;

  if (warp == kRingWarps) {
    // Producer: lane 0 fills the ring.
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&qmap))
                   : "memory");
      for (int i = 0; i < nst; ++i) {
#ifdef QT_QGEMV_NO_RING
        break;
#endif
        const int slot = i % stages;
        if (i >= stages) bar_wait(&empty[slot], ((i / stages) - 1) & 1);
#ifdef QT_QGEMV_NO_LOAD
        bar_arrive(&full[slot]);
#else
        bar_expect(&full[slot], kStageBytes);
        unsigned char* dst = ring + slot * kStageBytes;
        const int row = kbeg + i * br;
        for (int c = 0; c < nwc; ++c)   // one box a column group
          tma_load(dst + c * br * kBoxCols, &qmap, n0 + c * kBoxCols, row,
                  &full[slot]);
#endif
      }
    }
  } else {
    // The tile's scales, for the epilogue (read after a CTA barrier), and
    // x[:, kbeg:kbeg+nrow] (and the high half's rows for int4) in bf16,
    // xs[h][m][kk], one thread a 16-row block at a time, 16-byte loads
    // (scalar ones for an unaligned x or the split's last, partial block;
    // rows past the split are zero), kU blocks' loads in flight;
    // folded by inv_s as JAX does and put in the k order of the mma:
    // position 4 (r % 4) + r / 4 of a block holds its row r.
    for (int i = tid; i < tile_n; i += kRingWarps * 32)
      s_tile[i] = n0 + i < N ? s[n0 + i] : 0.f;
    {
      constexpr int kU = 4;
      const int nblk = nst * br / 16;             // blocks of a row of x
      const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                       K % 8 == 0 && Kq % 8 == 0;
      const int vblk = vec ? nrow / 16 : 0;       // whole, aligned blocks
      const int total = kH * M * nblk;
      for (int i0 = tid; i0 < total; i0 += kU * kRingWarps * 32) {
        uint4 raw[kU][2];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int i = i0 + u * kRingWarps * 32, blk = i % nblk;
          const int hm = i / nblk, m = hm % M, h = hm / M;
          if (i < total && blk < vblk) {
            const uint4* src = reinterpret_cast<const uint4*>(
                x + static_cast<int64_t>(m) * K + kbeg + h * Kq + blk * 16);
            raw[u][0] = __ldg(src);
            raw[u][1] = __ldg(src + 1);
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int i = i0 + u * kRingWarps * 32, blk = i % nblk;
          const int hm = i / nblk, m = hm % M, h = hm / M;
          if (i >= total) break;
          const int k0 = kbeg + h * Kq + blk * 16;  // x's column
          float v[16];
          if (blk < vblk) {
            Elem<__nv_bfloat16>::unpack(raw[u][0], v);
            Elem<__nv_bfloat16>::unpack(raw[u][1], v + 8);
          } else {
            const __nv_bfloat16* src = x + static_cast<int64_t>(m) * K + k0;
#pragma unroll
            for (int r = 0; r < 16; ++r)
              v[r] = blk * 16 + r < nrow ? __bfloat162float(src[r]) : 0.f;
          }
          if (inv_s != nullptr) {
#pragma unroll
            for (int r = 0; r < 16; ++r)
              if (blk * 16 + r < nrow)
                v[r] = Elem<__nv_bfloat16>::round(
                    v[r] * Elem<__nv_bfloat16>::round(inv_s[k0 + r]));
          }
          uint32_t o[8];
#pragma unroll
          for (int w = 0; w < 8; ++w) {   // out[2w], out[2w+1]: rows e0, e0+4
            const int e0 = w / 2 + 8 * (w & 1);
            o[w] = pack_bf16(v[e0], v[e0 + 4]);
          }
          uint4* dst = reinterpret_cast<uint4*>(
              xs + static_cast<int64_t>(hm) * P + blk * 16);
          dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
          dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
        }
      }
    }
    consumers_sync();  // the x slice is staged

    float sc[8];       // the lane's columns' scales (SCALE_EACH only)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
#ifdef QT_QGEMV_SCALE_EACH
      sc[e] = s_tile[cw * kBoxCols + 8 * cgp + e];
#else
      sc[e] = 1.f;
#endif
    }
    for (int i = 0; i < nst; ++i) {
      const int slot = i % stages;
#ifndef QT_QGEMV_NO_RING
      bar_wait(&full[slot], (i / stages) & 1);
#endif
      const unsigned char* grp =
          ring + slot * kStageBytes + cw * br * kBoxCols;
      // The warp's blocks of the stage, A words and B fragments into
      // registers; then the slot goes back to the producer.
      uint2 w[kWarpBlocks][4];
      uint32_t bx[kWarpBlocks][kSets][kH][2];
#pragma unroll
      for (int b = 0; b < kWarpBlocks; ++b) {
        const int kb = kw + b * nwk;              // 16-row block of the stage
        const int r0 = i * br + kb * 16;          // its row in the split
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = kb * 16 + t + 4 * j;    // row in the group
          const int off = row * kBoxCols +
                          ((((cgp >> 1) ^ ((row >> 1) & 3)) << 4) |
                           ((cgp & 1) << 3));
          w[b][j] = *reinterpret_cast<const uint2*>(grp + off);
        }
#pragma unroll
        for (int st = 0; st < kSets; ++st)
#pragma unroll
          for (int h = 0; h < kH; ++h) {
            uint2 v = make_uint2(0u, 0u);
            if (8 * st + g < M)
              v = *reinterpret_cast<const uint2*>(
                  xs + static_cast<int64_t>(h * M + 8 * st + g) * P + r0 +
                  4 * t);
            bx[b][st][h][0] = v.x;
            bx[b][st][h][1] = v.y;
          }
      }
      __syncwarp();
#ifndef QT_QGEMV_NO_RING
      if (lane == 0) bar_arrive(&empty[slot]);
#endif
#pragma unroll
      for (int b = 0; b < kWarpBlocks; ++b) {
#ifdef QT_QGEMV_NO_MATH
        acc[0][0][0] += __uint_as_float(w[b][0].x ^ w[b][1].y ^ w[b][2].x ^
                                        w[b][3].y ^ bx[b][0][0][0]);
        continue;
#endif
        if constexpr (BITS == 8) {
          unsigned u[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            u[j][0] = w[b][j].x ^ 0x80808080u;
            u[j][1] = w[b][j].y ^ 0x80808080u;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const uint32_t a0 = s8_pair(u[0][0], u[1][0], c, sc[c]);
            const uint32_t a1 = s8_pair(u[0][1], u[1][1], c, sc[c + 4]);
            const uint32_t a2 = s8_pair(u[2][0], u[3][0], c, sc[c]);
            const uint32_t a3 = s8_pair(u[2][1], u[3][1], c, sc[c + 4]);
#pragma unroll
            for (int st = 0; st < kSets; ++st)
              mma_bf16(acc[st][c], a0, a1, a2, a3, bx[b][st][0][0],
                       bx[b][st][0][1]);
          }
        } else {
          unsigned u[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            u[j][0] = w[b][j].x ^ 0x88888888u;
            u[j][1] = w[b][j].y ^ 0x88888888u;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            uint32_t lo[4], hi[4];
            s4_pair(u[0][0], u[1][0], c, sc[c], lo[0], hi[0]);
            s4_pair(u[0][1], u[1][1], c, sc[c + 4], lo[1], hi[1]);
            s4_pair(u[2][0], u[3][0], c, sc[c], lo[2], hi[2]);
            s4_pair(u[2][1], u[3][1], c, sc[c + 4], lo[3], hi[3]);
#pragma unroll
            for (int st = 0; st < kSets; ++st) {
              mma_bf16(acc[st][c], lo[0], lo[1], lo[2], lo[3],
                       bx[b][st][0][0], bx[b][st][0][1]);
              mma_bf16(acc[st][c], hi[0], hi[1], hi[2], hi[3],
                       bx[b][st][1][0], bx[b][st][1][1]);
            }
          }
        }
      }
    }
  }
  __syncthreads();  // every stage is read: the ring holds the warps' sums

  // red[kw][m][cl]: each warp's partial of its column group.
  if (warp < kRingWarps) {
#pragma unroll
    for (int st = 0; st < kSets; ++st)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int m = 8 * st + 2 * t + j;
          const int cl = cw * kBoxCols + 8 * cgp + c;
          if (m < M) {
            red[(kw * M + m) * rs + cl] = acc[st][c][j];
            red[(kw * M + m) * rs + cl + 4] = acc[st][c][2 + j];
          }
        }
  }
  __syncthreads();
#ifdef QT_QGEMV_SCALE_EACH
  const bool scale_out = false;
#else
  const bool scale_out = true;
#endif
#if defined(QT_QGEMV_TICKET_MERGE) || defined(QT_QGEMV_NO_MERGE)
  for (int i = tid; i < M * tile_n; i += blockDim.x) {
    const int m = i / tile_n, cl = i % tile_n, n = n0 + cl;
    if (n >= N) continue;
    float v = 0.f;
    for (int w = 0; w < nwk; ++w) v += red[(w * M + m) * rs + cl];
#ifdef QT_QGEMV_TICKET_MERGE
    if (ksplit > 1) {
      part[(static_cast<int64_t>(split) * M + m) * N + n] = v;
      continue;
    }
#endif
    out[static_cast<int64_t>(m) * N + n] =
        __float2bfloat16_rn(scale_out ? s_tile[cl] * v : v);
  }
#ifdef QT_QGEMV_TICKET_MERGE
  if (ksplit > 1)
    split_merge(out, part, tickets, scale_out ? s : nullptr, M, N, n0, tile_n,
                tile, ksplit, is_last);
#endif
  (void)recv;
#else
  (void)part;
  (void)tickets;
  (void)is_last;
  if (ksplit == 1) {
    for (int i = tid; i < M * tile_n; i += blockDim.x) {
      const int m = i / tile_n, cl = i % tile_n, n = n0 + cl;
      if (n >= N) continue;
      float v = 0.f;
      for (int w = 0; w < nwk; ++w) v += red[(w * M + m) * rs + cl];
      out[static_cast<int64_t>(m) * N + n] =
          __float2bfloat16_rn(scale_out ? s_tile[cl] * v : v);
    }
    return;
  }
  // Column cl belongs to rank cl % ksplit, slot cl / ksplit there; the
  // receive slots are [split][m][slot].
  cg::cluster_group cluster = cg::this_cluster();
  const int per = (tile_n + ksplit - 1) / ksplit;
  cluster_wait();   // every peer has started: its receive slots are live
  for (int i = tid; i < M * tile_n; i += blockDim.x) {
    const int m = i / tile_n, cl = i % tile_n;
    float v = 0.f;
    for (int w = 0; w < nwk; ++w) v += red[(w * M + m) * rs + cl];
    float* dst = cluster.map_shared_rank(recv, cl % ksplit);
    dst[(split * M + m) * per + cl / ksplit] = v;
  }
  cluster.sync();   // every partial has reached its owner
  for (int i = tid; i < M * per; i += blockDim.x) {
    const int m = i / per, j = i % per;
    const int cl = j * ksplit + split, n = n0 + cl;
    if (cl >= tile_n || n >= N) continue;
    float v = 0.f;
    for (int r = 0; r < ksplit; ++r) v += recv[(r * M + m) * per + j];
    out[static_cast<int64_t>(m) * N + n] =
        __float2bfloat16_rn(scale_out ? s_tile[cl] * v : v);
  }
#endif
}

// ---------------------------------------------------------------------------
// dequant. A lane owns 16 / sizeof(T) columns (8 for bf16, 4 for f32)
// for the whole launch (their scales in registers), so each of
// its stores of a row is one 16-byte store and a warp's is 512 contiguous
// bytes (whole lines). Grid (column blocks of 32 lanes, row groups): warp
// w of CTA (bx, by) takes q rows by * 8 + w + i * gridDim.y * 8, kU
// rows a step with their loads issued together. The launcher sizes the
// grid to 8 CTAs an SM (2048 threads). int4 writes each q byte's two
// nibbles to rows r and r + Kq. Plain stores: the evict-first hint
// (-DQT_DEQUANT_STCS, exp/qgemv_ablation.py) was no faster alone nor
// before the prefill's matmul, which reads the matrix next.
constexpr int kDeqWarps = 8;

template <typename T>
struct DeqLoad;
template <>
struct DeqLoad<__nv_bfloat16> {   // 8 q bytes a row
  static constexpr int kCols = 8, kU = 4;
  __device__ __forceinline__ static void load(const int8_t* p, unsigned* w) {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  }
};
template <>
struct DeqLoad<float> {           // 4 q bytes a row
  static constexpr int kCols = 4, kU = 8;
  __device__ __forceinline__ static void load(const int8_t* p, unsigned* w) {
    w[0] = __ldcs(reinterpret_cast<const unsigned*>(p));
  }
};

template <typename T>
__device__ __forceinline__ void deq_store(T* dst, const float* v) {
#ifdef QT_DEQUANT_STCS
#define QT_DEQ_ST(p, val) __stcs(p, val)
#else
#define QT_DEQ_ST(p, val) (*(p) = (val))
#endif
  if constexpr (sizeof(T) == 2) {
    QT_DEQ_ST(reinterpret_cast<uint4*>(dst),
              make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                         pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7])));
  } else {
    QT_DEQ_ST(reinterpret_cast<float4*>(dst),
              make_float4(v[0], v[1], v[2], v[3]));
  }
#undef QT_DEQ_ST
}

template <typename T, int BITS>
__global__ void __launch_bounds__(kDeqWarps * 32)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
               const float* __restrict__ inv_s, T* __restrict__ w, int K,
               int N) {
  using L = DeqLoad<T>;
  constexpr int kC = L::kCols, kU = L::kU, kWords = kC / 4;
  constexpr int kH = BITS == 4 ? 2 : 1;
  const int Kq = BITS == 4 ? K / 2 : K;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = (blockIdx.x * 32 + lane) * kC;
  if (col >= N) return;
  float sc[kC];
#pragma unroll
  for (int i = 0; i < kC; i += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(s + col + i));
    sc[i] = v.x;
    sc[i + 1] = v.y;
    sc[i + 2] = v.z;
    sc[i + 3] = v.w;
  }
  const int step = gridDim.y * kDeqWarps;
  for (int r0 = blockIdx.y * kDeqWarps + warp; r0 < Kq; r0 += kU * step) {
    unsigned raw[kU][kWords];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int row = r0 + u * step;
      if (row < Kq)
        L::load(q + static_cast<int64_t>(row) * N + col, raw[u]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int row = r0 + u * step;
      if (row >= Kq) break;
      float a[kH][kC];
#pragma unroll
      for (int wi = 0; wi < kWords; ++wi) {
        if constexpr (BITS == 8)
          s8x4_to_float(raw[u][wi], &a[0][wi * 4]);
        else
          s4x8_to_float(raw[u][wi], &a[0][wi * 4], &a[kH - 1][wi * 4]);
      }
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const int k = row + h * Kq;
        const float is = inv_s != nullptr ? inv_s[k] : 1.f;
#pragma unroll
        for (int e = 0; e < kC; ++e) {
          float v = a[h][e] * sc[e];
          if (inv_s != nullptr) v *= is;
          a[h][e] = v;
        }
        deq_store(w + static_cast<int64_t>(k) * N + col, a[h]);
      }
    }
  }
}

// dequant_kernel's function an element a thread, for an out its vector
// loads and stores cannot align (N % kCols != 0): the same arithmetic,
// so the same bits.
template <typename T, int BITS>
__global__ void __launch_bounds__(256)
dequant_any_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                   const float* __restrict__ inv_s, T* __restrict__ w, int K,
                   int N) {
  const int Kq = BITS == 4 ? K / 2 : K;
  const int64_t n = static_cast<int64_t>(Kq) * N;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(i / N), col = static_cast<int>(i % N);
    const int b = q[i];
    // int4: the low nibble sign-extended, then the high one.
    const int v[2] = {
        BITS == 4 ? static_cast<int>(static_cast<unsigned>(b) << 28) >> 28 : b,
        b >> 4};
#pragma unroll
    for (int h = 0; h < (BITS == 4 ? 2 : 1); ++h) {
      const int k = row + h * Kq;
      float a = static_cast<float>(v[h]) * s[col];
      if (inv_s != nullptr) a *= inv_s[k];
      store_f(w + static_cast<int64_t>(k) * N + col, a);
    }
  }
}

template <int BITS, int MR, int MG, typename XT>
cudaError_t launch_qgemv(const XT* x, const int8_t* q, const float* s,
                         const float* inv_s, XT* out, float* part,
                         int* tickets, int M, int K, int N, int chunk,
                         int ksplit, cudaStream_t stream) {
  const dim3 grid((N + kQTileN - 1) / kQTileN, ksplit);
  constexpr int kH = BITS == 4 ? 2 : 1;
  const size_t xs = static_cast<size_t>(MR * MG * kH) * chunk * sizeof(float);
  const size_t red = static_cast<size_t>(kQThreads / kQColThreads) * kQTileN *
                     sizeof(float);
  const size_t smem = xs > red ? xs : red;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // the plan's limit
  qgemv_kernel<BITS, MR, MG, XT><<<grid, kQThreads, smem, stream>>>(
      x, q, s, inv_s, out, part, tickets, M, K, N, chunk, ksplit);
  return cudaGetLastError();
}

// Attribute set, once a library (the port drives one card): a flag of
// internal linkage, since a function-local static of a template is one
// object across every library loaded in the process, and an ablation
// build is another one.
static bool g_ring_smem_set[2][2];  // [int4][16 rows]

template <int BITS, int MT>
cudaError_t launch_qgemv_ring(const CUtensorMap& map,
                              const __nv_bfloat16* x, const float* s,
                              const float* inv_s, __nv_bfloat16* out,
                              float* part, int* tickets,
                              int M, int K, int N, int chunk, int ksplit,
                              int tile_n, int stages, cudaStream_t stream) {
  const int br = kStageBytes / (tile_n > 0 ? tile_n : 1);
  // The warps' sums (2 KB a row of x, and the pads, within the staged x)
  // alias the ring after the loop.
  if ((tile_n != 64 && tile_n != 128 && tile_n != 256) || stages < 1 ||
      stages > kMaxStages || stages * kStageBytes < 2048 * M || ksplit < 1 ||
      ksplit > kMaxCluster || chunk <= 0 || chunk % br != 0)
    return cudaErrorInvalidValue;
  const size_t smem = ring_smem(BITS, M, chunk, ksplit, tile_n, stages);
  if (smem > kRingDynamicMax) return cudaErrorInvalidValue;
  bool& smem_set = g_ring_smem_set[BITS == 4][MT == 16];
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        qgemv_ring_kernel<BITS, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kRingDynamicMax);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ksplit, (N + tile_n - 1) / tile_n, 1);
  cfg.blockDim = dim3(kRingThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
#ifdef QT_QGEMV_TICKET_MERGE
  attr[0].val.clusterDim.x = 1;
#else
  attr[0].val.clusterDim.x = ksplit;
#endif
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = attr[0].val.clusterDim.x > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, qgemv_ring_kernel<BITS, MT>, map, x, s, inv_s, out, part, tickets,
      M, K, N, chunk, tile_n, stages);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BITS, typename XT>
cudaError_t qgemv_fma_rows(const void* x, const int8_t* q, const float* s,
                           const float* inv_s, void* out, float* part,
                           int* tickets, int M, int K, int N, int chunk,
                           int ksplit, cudaStream_t st) {
  const auto* xf = static_cast<const XT*>(x);
  auto* of = static_cast<XT*>(out);
#define QT_QGEMV(MR, MG)                                                    \
  return launch_qgemv<BITS, MR, MG, XT>(xf, q, s, inv_s, of, part, tickets, \
                                        M, K, N, chunk, ksplit, st)
  if (M <= 1) QT_QGEMV(1, 1);
  if (M <= 2) QT_QGEMV(2, 1);
  if (M <= 4) QT_QGEMV(4, 1);
  if (M <= 8) QT_QGEMV(4, 2);
  if (M <= 16) QT_QGEMV(4, 4);
#undef QT_QGEMV
  return cudaErrorInvalidValue;
}

// bf16 x with a ring plan (stages > 0): qgemv_ring_kernel; f32 x, and
// bf16 x with the FMA plan (stages == 0, an out not a multiple of 16):
// qgemv_kernel in x's dtype.
template <int BITS>
cudaError_t qgemv_rows(bool x_bf16, const void* tmap, const void* x,
                       const int8_t* q, const float* s, const float* inv_s,
                       void* out, float* part, int* tickets, int M, int K,
                       int N, int chunk, int ksplit, int tile_n, int stages,
                       cudaStream_t st) {
  if (x_bf16 && stages == 0)
    return qgemv_fma_rows<BITS, __nv_bfloat16>(x, q, s, inv_s, out, part,
                                               tickets, M, K, N, chunk,
                                               ksplit, st);
  if (x_bf16) {
    if (tmap == nullptr) return cudaErrorInvalidValue;
    CUtensorMap map;
    memcpy(&map, tmap, sizeof(map));
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (M <= 8)
      return launch_qgemv_ring<BITS, 8>(map, xb, s, inv_s, ob, part, tickets,
                                        M, K, N, chunk, ksplit, tile_n, stages,
                                        st);
    if (M <= 16)
      return launch_qgemv_ring<BITS, 16>(map, xb, s, inv_s, ob, part, tickets,
                                         M, K, N, chunk, ksplit, tile_n,
                                         stages, st);
    return cudaErrorInvalidValue;
  }
  return qgemv_fma_rows<BITS, float>(x, q, s, inv_s, out, part, tickets, M,
                                     K, N, chunk, ksplit, st);
}

static int g_deq_ctas;  // 8 CTAs of 256 threads an SM, read once

template <typename T>
cudaError_t dequant_bits(int bits, const int8_t* q, const float* s,
                         const float* inv_s, void* w, int K, int N,
                         cudaStream_t st) {
  if (g_deq_ctas == 0) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    g_deq_ctas = 8 * sms;
  }
  const int Kq = bits == 4 ? K / 2 : K;
  if (N % DeqLoad<T>::kCols != 0) {  // rows the vector path cannot align
    const int64_t n = static_cast<int64_t>(Kq) * N;
    const int blocks = static_cast<int>(
        (n + 255) / 256 < g_deq_ctas ? (n + 255) / 256 : g_deq_ctas);
    if (bits == 8)
      dequant_any_kernel<T, 8><<<blocks, 256, 0, st>>>(
          q, s, inv_s, static_cast<T*>(w), K, N);
    else if (bits == 4)
      dequant_any_kernel<T, 4><<<blocks, 256, 0, st>>>(
          q, s, inv_s, static_cast<T*>(w), K, N);
    else
      return cudaErrorInvalidValue;
    return cudaGetLastError();
  }
  const int cols = 32 * DeqLoad<T>::kCols;
  const int bx = (N + cols - 1) / cols;
  int by = (g_deq_ctas + bx - 1) / bx;
  by = by < 1 ? 1 : by;
  const int rows = (Kq + kDeqWarps - 1) / kDeqWarps;
  by = by > rows ? rows : by;
  const dim3 grid(bx, by);
  if (bits == 8)
    dequant_kernel<T, 8><<<grid, kDeqWarps * 32, 0, st>>>(
        q, s, inv_s, static_cast<T*>(w), K, N);
  else if (bits == 4)
    dequant_kernel<T, 4><<<grid, kDeqWarps * 32, 0, st>>>(
        q, s, inv_s, static_cast<T*>(w), K, N);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace qt

// x [M, K] (bf16 when x_bf16, else f32); q int8 [Kq, N]; s [N] f32;
// inv_s [K] f32 or null; out [M, N] in x's dtype. bf16 x: tmap from
// qgemv_tensor_map for q, the plan's chunk, ksplit (the cluster), tile_n
// and stages. f32 x: chunk, ksplit, and part [ksplit, M, N] f32 and
// tickets [ceil(N / 256)] int32 (zero; left zero) when ksplit > 1.
extern "C" int qgemv_launch(const void* x, const int8_t* q, const float* s,
                            const float* inv_s, void* out, float* part,
                            int* tickets, int M, int K, int N, int bits,
                            int x_bf16, int chunk, int ksplit, int tile_n,
                            int stages, const void* tmap, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (bits == 8)
    err = qt::qgemv_rows<8>(x_bf16, tmap, x, q, s, inv_s, out, part, tickets,
                            M, K, N, chunk, ksplit, tile_n, stages, st);
  else if (bits == 4)
    err = qt::qgemv_rows<4>(x_bf16, tmap, x, q, s, inv_s, out, part, tickets,
                            M, K, N, chunk, ksplit, tile_n, stages, st);
  return static_cast<int>(err);
}

// The TMA descriptor of one layer of q, int8 [rows, cols] (cols a
// multiple of 16, the base 16-byte aligned): boxes of box_rows (a ring
// stage's rows: 64, 128 or 256) by 64 columns with the 64-byte swizzle;
// reads past the matrix are zeros. Writes the 128-byte CUtensorMap to
// `out`; returns the CUresult, or -1 when the driver has no
// cuTensorMapEncodeTiled.
extern "C" int qgemv_tensor_map(void* base, long long rows, long long cols,
                                int box_rows, void* out) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {qt::kBoxCols, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides, box,
      elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) memcpy(out, &map, sizeof(map));
  return static_cast<int>(r);
}

// q int8 [Kq, N]; s [N] f32; inv_s [K] f32 or null; w [K, N] (bf16 when
// w_bf16, else f32).
extern "C" int dequant_launch(const int8_t* q, const float* s,
                              const float* inv_s, void* w, int K, int N,
                              int bits, int w_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      w_bf16 ? qt::dequant_bits<__nv_bfloat16>(bits, q, s, inv_s, w, K, N, st)
             : qt::dequant_bits<float>(bits, q, s, inv_s, w, K, N, st);
  return static_cast<int>(err);
}
