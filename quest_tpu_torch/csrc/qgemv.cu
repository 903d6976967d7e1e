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
// fold, optional). The rounding points are JAX's: each weight is
// (dtype)(float(q) * s[j]); the activation is folded as
// (dtype)(x * (dtype)inv_s) while it is staged; products accumulate in
// f32. For int4 JAX rounds each nibble half's product to the dtype before
// adding them; this kernel sums both halves in f32 and rounds once.
//
// qgemv, x [M <= 16, in] (bf16 or f32) -> out [M, out] in x's dtype.
// Bound on the H100: bytes, the packed weights read once (58.7 MB for
// Llama-3.1-8B's w_gate in int8, 29.4 MB in int4, against 3.35 TB/s).
// But every weight has to be unpacked, scaled and rounded on its own (the
// scale and the rounding are per weight, so they cannot leave the loop),
// a few integer and float operations each, so the issue rate is the other
// limit, and int4 (twice the weights a byte) meets it first. Two kernels:
// - bf16 x (every decode step of a bf16 model): qgemv_mma_kernel, the
//   products on the tensor cores, ~4 operations a weight whatever M;
// - f32 x (the f32 lm_head product, f32 models): qgemv_kernel, FMA in
//   f32, ~7 operations a weight at M = 2, the M-row FMAs on top.
// Both: a CTA owns a tile of 256 columns and a split of the input rows; a
// thread's load is 16 bytes of a q row (16 columns), coalesced across the
// threads of the row, the next loads in flight while it works on the
// current ones; the split's slice of x is staged in shared memory once. A
// grid over column tiles alone gives 4-501 CTAs at the layers' widths, so
// the input rows are split across CTAs; the plan (ops/qdot.py:
// qgemv_plan) weighs waves against each CTA's fixed cost (staging, its
// reduction, its partial), which a card run measured at ~5 us a wave
// (exp/qgemv_ablation.py). The last CTA of a column tile to take a ticket
// adds the f32 partials in split order and resets the ticket to zero.
//
// dequant, q -> w [in, out] in bf16 or f32, bitwise equal to
// dequantize_weight: (dtype)(float(q) * s[j] [* inv_s[i]]). Bound: bytes,
// q read once and w written once.
#include "mma.cuh"

namespace qt {

constexpr int kQThreads = 256;
constexpr int kQCols = 16;                     // columns a thread
constexpr int kQColThreads = 16;               // threads across a tile
constexpr int kQTileN = kQCols * kQColThreads;  // 256 columns a CTA

// q is streamed once: loaded with the evict-first hint. The ablation
// builds (exp/qgemv_ablation.py) compile out the loads (the bytes come
// from the address) or the arithmetic (one add a word).
#ifdef QT_QGEMV_NO_LOAD
#define QT_QLOAD(p)                                                     \
  make_uint4(static_cast<unsigned>(reinterpret_cast<uintptr_t>(p)),     \
             0x01020304u, 0x05060708u, 0x090a0b0cu)
#else
#define QT_QLOAD(p) __ldcs(reinterpret_cast<const uint4*>(p))
#endif

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
__device__ __forceinline__ float round_f(float v) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(v));
  else return v;
}

template <typename T>
__device__ __forceinline__ void store_f(T* p, float v) {
  if constexpr (sizeof(T) == 2) *p = __float2bfloat16_rn(v);
  else *p = v;
}

// The split merge, after a CTA stored its partial for rows [0, M) of the
// 256-column tile at n0: the last CTA of the tile to take a ticket adds
// every split's partial, in split order (a batch of splits' loads issued
// together), writes out and leaves the ticket at zero. Every thread of
// the CTA calls it; ``is_last`` is a shared int of the caller's.
template <typename T>
__device__ __forceinline__ void split_merge(T* out, const float* part,
                                            int* tickets, int M, int N,
                                            int n0, int tile, int ksplit,
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
  for (int i = tid; i < M * kQTileN; i += kQThreads) {
    const int m = i / kQTileN, n = n0 + i % kQTileN;
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
    store_f(out + static_cast<int64_t>(m) * N + n, v);
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
template <int BITS, int MR, int MG>
__global__ void __launch_bounds__(kQThreads, 2)
qgemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
             const float* __restrict__ s, const float* __restrict__ inv_s,
             float* __restrict__ out, float* __restrict__ part,
             int* __restrict__ tickets, int M, int K, int N, int chunk,
             int ksplit) {
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
  const int kbeg = split * chunk;
  const int nrow = min(Kq, kbeg + chunk) - kbeg;

  float sc[kQCols];
#pragma unroll
  for (int i = 0; i < kQCols; i += 4) {
    const float4 v = col_ok ? __ldg(reinterpret_cast<const float4*>(s + col + i))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
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
                 ? QT_QLOAD(qb + static_cast<int64_t>(kk) * N)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  // Stage x[:, kbeg:kbeg+nrow] (and the high half's rows for int4),
  // folded by inv_s and rounded to T as JAX does; rows past M are zero.
  for (int i = tid; i < kMT * kH * nrow; i += kQThreads) {
    const int kk = i % nrow, h = (i / nrow) % kH, m = i / (nrow * kH);
    float v = 0.f;
    if (m < M) {
      const int k = kbeg + kk + h * Kq;
      v = x[static_cast<int64_t>(m) * K + k];
      if (inv_s != nullptr) v *= inv_s[k];
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
                   ? QT_QLOAD(qb + static_cast<int64_t>(kk) * N)
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
#ifdef QT_QGEMV_NO_MATH
        acc[0][wi * 4] += __uint_as_float(wd[wi]) * xv[0][0];
        continue;
#endif
        if constexpr (BITS == 8) {
          float w[4];
          s8x4_to_float(wd[wi], w);
#pragma unroll
          for (int e = 0; e < 4; ++e) w[e] *= sc[wi * 4 + e];
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
            lo[e] *= sc[wi * 4 + e];
            hi[e] *= sc[wi * 4 + e];
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
        out[static_cast<int64_t>(m) * N + n] = v;
      else
        part[(static_cast<int64_t>(split) * M + m) * N + n] = v;
    }
  }
  if (ksplit == 1) return;

  split_merge(out, part, tickets, M, N, n0, tile, ksplit, is_last);
}

// bf16 activations: the products on the tensor cores (mma.sync
// m16n8k16, f32 accumulation), so a thread's arithmetic is the unpacking
// alone. The mma computes out^T = W^T x^T: A is 16 weight columns by 16 q
// rows, B 16 q rows by 8 rows of x. A warp owns 128 columns of the tile
// and a CTA's 8 warps are 2 across the tile by 4 along its rows (each
// takes every 4th block of 16 q rows). Lane (g = lane / 4, t = lane % 4)
// loads columns [16 g, 16 g + 16) of q rows 4 t .. 4 t + 3 of a block,
// four 16-byte loads, which are its A fragments of 8 mma instructions
// when, in the c-th of them, the mma's row g stands for column 16 g + c,
// row g + 8 for column 16 g + c + 8, and its k index 2 t + i for q row
// 4 t + i, 2 t + 8 + i for row 4 t + 2 + i (i = 0, 1): each weight is
// unpacked, scaled and rounded to bf16 straight into its fragment
// register. The B fragments are x's rows at those q rows, from the slice
// staged in shared memory in bf16 (rows past M and past the split are
// zero): one set for M <= 8, two for M <= 16 (MT).
constexpr int kMmaKWarps = 4;          // warps along a CTA's rows
constexpr int kMmaBlock = 16;          // q rows an mma block

template <int BITS, int MT>
__global__ void __launch_bounds__(kQThreads, MT == 8 ? 2 : 1)
qgemv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ q, const float* __restrict__ s,
                 const float* __restrict__ inv_s,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                 int* __restrict__ tickets, int M, int K, int N, int chunk,
                 int ksplit) {
  constexpr int kH = BITS == 4 ? 2 : 1;
  constexpr int kSets = MT / 8;        // mma sets: x rows 0-7, 8-15
  extern __shared__ __align__(16) unsigned char smraw[];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int cw = warp % 2, kw = warp / 2;
  const int Kq = BITS == 4 ? K / 2 : K;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int n0 = tile * kQTileN;
  const int col = n0 + cw * 128 + g * kQCols;
  const bool col_ok = col < N;
  const int kbeg = split * chunk;
  const int nrow = min(Kq, kbeg + chunk) - kbeg;
  const int nblock = (nrow + kMmaBlock - 1) / kMmaBlock;
  const int xstride = nblock * kMmaBlock;            // bf16 a staged row
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smraw);
  float* red = reinterpret_cast<float*>(
      smraw + ((static_cast<size_t>(MT) * kH * xstride * 2 + 15) & ~15));

  // Block b of this split: this thread's rows kbeg + 16 b + 4 t + i.
  const int8_t* qb = q + (static_cast<int64_t>(kbeg) + 4 * t) * N + col;
  auto load = [&](uint4* dst, int b) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = b * kMmaBlock + 4 * t + i;
      dst[i] = (col_ok && b < nblock && kk < nrow)
                   ? QT_QLOAD(qb + (static_cast<int64_t>(b) * kMmaBlock + i) * N)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  uint4 cur[4];
  load(cur, kw);

  float sc[kQCols];
#pragma unroll
  for (int i = 0; i < kQCols; i += 4) {
    const float4 v = col_ok ? __ldg(reinterpret_cast<const float4*>(s + col + i))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    sc[i] = v.x;
    sc[i + 1] = v.y;
    sc[i + 2] = v.z;
    sc[i + 3] = v.w;
  }
  // Stage x[:, kbeg:kbeg+nrow] (and the high half's rows for int4) in bf16,
  // folded by inv_s as JAX does: xs[m][h][kk].
  for (int i = tid; i < MT * kH * xstride; i += kQThreads) {
    const int kk = i % xstride, h = (i / xstride) % kH, m = i / (xstride * kH);
    float v = 0.f;
    if (m < M && kk < nrow) {
      const int k = kbeg + kk + h * Kq;
      v = __bfloat162float(x[static_cast<int64_t>(m) * K + k]);
      if (inv_s != nullptr) v = round_f<__nv_bfloat16>(
          v * round_f<__nv_bfloat16>(inv_s[k]));
    }
    xs[i] = __float2bfloat16_rn(v);
  }
  // acc[set][c]: D rows g, g + 8 (columns 16 g + c, + 8) by x rows
  // 8 set + 2 t, + 1.
  float acc[kSets][kQCols / 2][4];
#pragma unroll
  for (int st = 0; st < kSets; ++st)
#pragma unroll
    for (int c = 0; c < kQCols / 2; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[st][c][e] = 0.f;
  __syncthreads();  // the x slice is staged

  for (int b = kw; b < nblock; b += kMmaKWarps) {
    uint4 nxt[4];
    load(nxt, b + kMmaKWarps);
    // B fragments: x row 8 set + g at k pairs (4 t, 4 t + 1) and
    // (4 t + 2, 4 t + 3).
    uint32_t bx[kSets][kH][2];
#pragma unroll
    for (int st = 0; st < kSets; ++st)
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const __nv_bfloat16* r = xs + ((8 * st + g) * kH + h) * xstride +
                                 b * kMmaBlock + 4 * t;
        bx[st][h][0] = ld_u32(r);
        bx[st][h][1] = ld_u32(r + 2);
      }
    const unsigned wd[4][4] = {{cur[0].x, cur[0].y, cur[0].z, cur[0].w},
                               {cur[1].x, cur[1].y, cur[1].z, cur[1].w},
                               {cur[2].x, cur[2].y, cur[2].z, cur[2].w},
                               {cur[3].x, cur[3].y, cur[3].z, cur[3].w}};
    // Words wi and wi + 2 of each row: columns 4 wi + e and 4 wi + e + 8.
#pragma unroll
    for (int wi = 0; wi < 2; ++wi) {
#ifdef QT_QGEMV_NO_MATH
      acc[0][wi][0] += __uint_as_float(wd[0][wi]) + __uint_as_float(wd[3][wi + 2]);
      continue;
#endif
      float f[kH][4][8];  // [half][row i][column: 4 wi + e, then + 8]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          if constexpr (BITS == 8) s8x4_to_float(wd[i][wi + 2 * p], &f[0][i][4 * p]);
          else s4x8_to_float(wd[i][wi + 2 * p], &f[0][i][4 * p], &f[kH - 1][i][4 * p]);
        }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = wi * 4 + e;
        const float s0 = sc[c], s8 = sc[c + 8];
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          const uint32_t a0 = pack_bf16(f[h][0][e] * s0, f[h][1][e] * s0);
          const uint32_t a1 = pack_bf16(f[h][0][4 + e] * s8, f[h][1][4 + e] * s8);
          const uint32_t a2 = pack_bf16(f[h][2][e] * s0, f[h][3][e] * s0);
          const uint32_t a3 = pack_bf16(f[h][2][4 + e] * s8, f[h][3][4 + e] * s8);
#pragma unroll
          for (int st = 0; st < kSets; ++st)
            mma_bf16(acc[st][c], a0, a1, a2, a3, bx[st][h][0], bx[st][h][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) cur[i] = nxt[i];
  }

  // Sum the 4 row warps through shared memory: red[kw][m][column].
#pragma unroll
  for (int st = 0; st < kSets; ++st)
#pragma unroll
    for (int c = 0; c < kQCols / 2; ++c)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int m = 8 * st + 2 * t + j;
        const int cl = cw * 128 + g * kQCols + c;
        if (m < M) {
          red[(kw * MT + m) * kQTileN + cl] = acc[st][c][j];
          red[(kw * MT + m) * kQTileN + cl + 8] = acc[st][c][2 + j];
        }
      }
  __syncthreads();
  for (int i = tid; i < M * kQTileN; i += kQThreads) {
    const int m = i / kQTileN, cl = i % kQTileN, n = n0 + cl;
    if (n >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaKWarps; ++w) v += red[(w * MT + m) * kQTileN + cl];
    if (ksplit == 1)
      out[static_cast<int64_t>(m) * N + n] = __float2bfloat16_rn(v);
    else
      part[(static_cast<int64_t>(split) * M + m) * N + n] = v;
  }
  if (ksplit == 1) return;
  split_merge(out, part, tickets, M, N, n0, tile, ksplit, is_last);
}

// One thread a 16-byte column chunk of q over kQDeqRows rows: 16 weights
// a row (int8) or 16 of each nibble half (int4), written as 16 contiguous
// elements of w's row (and of row + Kq). Grid (column chunks / 256,
// row groups).
constexpr int kQDeqRows = 8;

template <typename T, int BITS>
__global__ void __launch_bounds__(kQThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
               const float* __restrict__ inv_s, T* __restrict__ w, int K,
               int N) {
  constexpr int kH = BITS == 4 ? 2 : 1;
  const int Kq = BITS == 4 ? K / 2 : K;
  const int cidx = blockIdx.x * kQThreads + threadIdx.x;
  if (cidx >= N / kQCols) return;
  const int col = cidx * kQCols;
  float sc[kQCols];
#pragma unroll
  for (int i = 0; i < kQCols; i += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(s + col + i));
    sc[i] = v.x;
    sc[i + 1] = v.y;
    sc[i + 2] = v.z;
    sc[i + 3] = v.w;
  }
  const int r0 = blockIdx.y * kQDeqRows;
  uint4 raw[kQDeqRows];
#pragma unroll
  for (int i = 0; i < kQDeqRows; ++i)
    raw[i] = r0 + i < Kq ? __ldcs(reinterpret_cast<const uint4*>(
                               q + static_cast<int64_t>(r0 + i) * N + col))
                         : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int i = 0; i < kQDeqRows; ++i) {
    const int row = r0 + i;
    if (row >= Kq) break;
    const unsigned wd[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
    float a[kH][kQCols];
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
      if constexpr (BITS == 8) {
        s8x4_to_float(wd[wi], &a[0][wi * 4]);
      } else {
        s4x8_to_float(wd[wi], &a[0][wi * 4], &a[kH - 1][wi * 4]);
      }
    }
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const int k = row + h * Kq;
      const float is = inv_s != nullptr ? inv_s[k] : 1.f;
      T* dst = w + static_cast<int64_t>(k) * N + col;
#pragma unroll
      for (int e = 0; e < kQCols; ++e) {
        float v = a[h][e] * sc[e];
        if (inv_s != nullptr) v *= is;
        a[h][e] = v;
      }
      if constexpr (sizeof(T) == 2) {
        uint4 o[2];
        unsigned* ou = reinterpret_cast<unsigned*>(o);
#pragma unroll
        for (int e = 0; e < kQCols; e += 2) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(a[h][e], a[h][e + 1]);
          ou[e / 2] = *reinterpret_cast<const unsigned*>(&b);
        }
        __stcs(reinterpret_cast<uint4*>(dst), o[0]);
        __stcs(reinterpret_cast<uint4*>(dst) + 1, o[1]);
      } else {
#pragma unroll
        for (int e = 0; e < kQCols; e += 4)
          __stcs(reinterpret_cast<float4*>(dst) + e / 4,
                 make_float4(a[h][e], a[h][e + 1], a[h][e + 2], a[h][e + 3]));
      }
    }
  }
}

template <int BITS, int MR, int MG>
cudaError_t launch_qgemv(const float* x, const int8_t* q, const float* s,
                         const float* inv_s, float* out, float* part,
                         int* tickets, int M, int K, int N, int chunk,
                         int ksplit, cudaStream_t stream) {
  const dim3 grid((N + kQTileN - 1) / kQTileN, ksplit);
  constexpr int kH = BITS == 4 ? 2 : 1;
  const size_t xs = static_cast<size_t>(MR * MG * kH) * chunk * sizeof(float);
  const size_t red = static_cast<size_t>(kQThreads / kQColThreads) * kQTileN *
                     sizeof(float);
  const size_t smem = xs > red ? xs : red;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;  // the plan's limit
  qgemv_kernel<BITS, MR, MG><<<grid, kQThreads, smem, stream>>>(
      x, q, s, inv_s, out, part, tickets, M, K, N, chunk, ksplit);
  return cudaGetLastError();
}

static bool g_mma_smem_set[2][2];  // [int4][16 rows]: attribute set

template <int BITS, int MT>
cudaError_t launch_qgemv_mma(const __nv_bfloat16* x, const int8_t* q,
                             const float* s, const float* inv_s,
                             __nv_bfloat16* out, float* part, int* tickets,
                             int M, int K, int N, int chunk, int ksplit,
                             cudaStream_t stream) {
  constexpr int kH = BITS == 4 ? 2 : 1;
  constexpr int kRedBytes = kMmaKWarps * MT * kQTileN * sizeof(float);
  const size_t rows = (chunk + kMmaBlock - 1) / kMmaBlock * kMmaBlock;
  const size_t xs = (static_cast<size_t>(MT) * kH * rows * 2 + 15) & ~size_t(15);
  if (xs > 48 * 1024) return cudaErrorInvalidValue;  // the plan's limit
  // Once a library (the port drives one card). A flag of internal linkage:
  // a function-local static of a template is one object across every
  // library loaded in the process, and an ablation build is another one.
  bool& smem_set = g_mma_smem_set[BITS == 4][MT == 16];
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        qgemv_mma_kernel<BITS, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 48 * 1024 + kRedBytes);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((N + kQTileN - 1) / kQTileN, ksplit);
  qgemv_mma_kernel<BITS, MT><<<grid, kQThreads, xs + kRedBytes, stream>>>(
      x, q, s, inv_s, out, part, tickets, M, K, N, chunk, ksplit);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t qgemv_rows(bool x_bf16, const void* x, const int8_t* q,
                       const float* s, const float* inv_s, void* out,
                       float* part, int* tickets, int M, int K, int N,
                       int chunk, int ksplit, cudaStream_t st) {
  if (x_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    if (M <= 8)
      return launch_qgemv_mma<BITS, 8>(xb, q, s, inv_s, ob, part, tickets, M,
                                       K, N, chunk, ksplit, st);
    if (M <= 16)
      return launch_qgemv_mma<BITS, 16>(xb, q, s, inv_s, ob, part, tickets,
                                        M, K, N, chunk, ksplit, st);
    return cudaErrorInvalidValue;
  }
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
#define QT_QGEMV(MR, MG)                                                  \
  return launch_qgemv<BITS, MR, MG>(xf, q, s, inv_s, of, part, tickets, M, \
                                    K, N, chunk, ksplit, st)
  if (M <= 1) QT_QGEMV(1, 1);
  if (M <= 2) QT_QGEMV(2, 1);
  if (M <= 4) QT_QGEMV(4, 1);
  if (M <= 8) QT_QGEMV(4, 2);
  if (M <= 16) QT_QGEMV(4, 4);
#undef QT_QGEMV
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dequant_bits(int bits, const int8_t* q, const float* s,
                         const float* inv_s, void* w, int K, int N,
                         cudaStream_t st) {
  const int Kq = bits == 4 ? K / 2 : K;
  const dim3 grid((N / kQCols + kQThreads - 1) / kQThreads,
                  (Kq + kQDeqRows - 1) / kQDeqRows);
  if (bits == 8)
    dequant_kernel<T, 8><<<grid, kQThreads, 0, st>>>(q, s, inv_s,
                                                     static_cast<T*>(w), K, N);
  else if (bits == 4)
    dequant_kernel<T, 4><<<grid, kQThreads, 0, st>>>(q, s, inv_s,
                                                     static_cast<T*>(w), K, N);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace qt

// x [M, K] (bf16 when x_bf16, else f32); q int8 [Kq, N]; s [N] f32;
// inv_s [K] f32 or null; out [M, N] in x's dtype; part [ksplit, M, N]
// f32 and tickets [ceil(N / 256)] int32 (zero; left zero) when ksplit > 1.
extern "C" int qgemv_launch(const void* x, const int8_t* q, const float* s,
                            const float* inv_s, void* out, float* part,
                            int* tickets, int M, int K, int N, int bits,
                            int x_bf16, int chunk, int ksplit, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (bits == 8)
    err = qt::qgemv_rows<8>(x_bf16, x, q, s, inv_s, out, part, tickets, M, K,
                            N, chunk, ksplit, st);
  else if (bits == 4)
    err = qt::qgemv_rows<4>(x_bf16, x, q, s, inv_s, out, part, tickets, M, K,
                            N, chunk, ksplit, st);
  return static_cast<int>(err);
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
