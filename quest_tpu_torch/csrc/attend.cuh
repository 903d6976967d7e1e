// One warp's flash-decode attention over chunks of up to 16 tokens on the
// tensor cores, shared by the sparse and dense decode kernels
// (decode_common.cuh) and the fused decode kernel (fused_decode.cu).
//
// mma.sync m16n8k16 with the G <= 8 query heads of a group as the rows
// (padded to 16; lane l holds head l / 4): QK^T takes K^T as B (8 tokens a
// tile, straight from the K rows); its C fragments, rounded to bf16,
// are PV's A (16 tokens a step), and V comes in through ldmatrix.trans.
// The warp keeps its own online softmax (m, l, acc), so no CTA barrier
// sits in a loop over chunks.
//
// The two q conventions of the callers: the sparse and dense kernels hand
// in q scaled by the softmax scale in f32 and rounded to bf16, and
// multiply the scores by 1; the fused kernel hands in the un-scaled q
// rounded to its metadata dtype and multiplies the f32 scores by the
// scale. Either way p is rounded to bf16 before PV, l sums the unrounded
// p, and a masked token scores the mask value and weighs 0.
#pragma once

#include "mma.cuh"

namespace qt {

constexpr int kChunk = 16;  // tokens a tensor-core chunk

// Where a warp's chunk lies in shared memory: rows of 128 bf16, K row r
// and V row r for r < 16. k(j, kk, sec) is the lane's 4-byte K word of
// QK^T step kk (row 8 j + gid, dims 16 kk + 2 tig + 8 sec); v(d16) the
// lane's ldmatrix.trans row address of PV step d16 (token (lane & 7) +
// 8 ((lane >> 3) & 1), dims 16 d16 + 8 (lane >> 4)).
//
// PaddedRows: rows STR elements apart (STR = 136: lanes reading one
// column of 8 rows hit distinct banks).
template <int STR>
struct PaddedRows {
  const __nv_bfloat16* kb;
  const __nv_bfloat16* vb;
  __device__ __forceinline__ const __nv_bfloat16* k(int j, int kk,
                                                    int sec) const {
    const int lane = threadIdx.x & 31;
    return kb + (8 * j + (lane >> 2)) * STR + kk * 16 + 2 * (lane & 3) +
           8 * sec;
  }
  __device__ __forceinline__ const __nv_bfloat16* v(int d16) const {
    const int lane = threadIdx.x & 31;
    return vb + ((lane & 7) + ((lane >> 3) & 1) * 8) * STR + (lane >> 4) * 8 +
           d16 * 16;
  }
};

// SwizzledRows: 256-byte rows as TMA writes them with the 128-byte
// swizzle (the 16-byte chunk c of each 128-byte segment lies at c ^ (the
// segment's address bits 7-9)); each row anywhere, 256-byte aligned, in
// a region whose copies start 1024-byte aligned. The lane's rows are set
// once a chunk: krow[j] (row 8 j + gid), vrow (its ldmatrix token).
struct SwizzledRows {
  const unsigned char* krow[2];
  const unsigned char* vrow;
  __device__ __forceinline__ static const unsigned char* at(
      const unsigned char* row, int chunk) {
    const unsigned char* seg = row + (chunk >> 3) * 128;
    return seg + (((chunk & 7) ^ ((smem_u32(seg) >> 7) & 7)) << 4);
  }
  __device__ __forceinline__ const __nv_bfloat16* k(int j, int kk,
                                                    int sec) const {
    return reinterpret_cast<const __nv_bfloat16*>(
        at(krow[j], 2 * kk + sec) + 4 * (threadIdx.x & 3));
  }
  __device__ __forceinline__ const __nv_bfloat16* v(int d16) const {
    return reinterpret_cast<const __nv_bfloat16*>(
        at(vrow, 2 * d16 + ((threadIdx.x & 31) >> 4)));
  }
};

struct WarpAttn {
  float m, l;          // head gid's running maximum and sum
  float acc[16][4];    // head gid's output dims 8 j + 2 tig, + 1 (and the
                       // padded head gid + 8's in [2], [3])
  uint32_t qa[8][2];   // head gid's query row as mma A fragments

  // qrow: the lane's head row (G <= 8 rows, f32 holding bf16 values), or
  // null for a padded head.
  __device__ __forceinline__ void init(const float* qrow) {
    const int tig = threadIdx.x & 3;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const float* qr = qrow + kk * 16 + 2 * tig;
      qa[kk][0] = qrow != nullptr ? pack_bf16(qr[0], qr[1]) : 0u;
      qa[kk][1] = qrow != nullptr ? pack_bf16(qr[8], qr[9]) : 0u;
    }
    m = QT_MASK_VALUE;
    l = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }

  // One chunk of 16 token rows as ``rows`` gives them (PaddedRows or
  // SwizzledRows; rows that are not tokens must hold finite values, e.g.
  // zeros); bit r of ``valid`` says token r counts. Whole warp.
  template <typename Rows>
  __device__ __forceinline__ void chunk(const Rows& rows, float s_mul,
                                        unsigned valid) {
    const int lane = threadIdx.x & 31, tig = lane & 3;
    float sc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        mma_bf16(sc[j], qa[kk][0], 0u, qa[kk][1], 0u, ld_u32(rows.k(j, kk, 0)),
                 ld_u32(rows.k(j, kk, 1)));
    }
    // Online softmax of head gid over the chunk's 16 tokens (4 lanes hold
    // them).
    float mx = QT_MASK_VALUE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = (valid >> (8 * j + 2 * tig + e)) & 1u ? sc[j][e] * s_mul
                                                          : QT_MASK_VALUE;
        mx = fmaxf(mx, sc[j][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
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
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m - m_new);
    l = alpha * l + sum;
    m = m_new;
    const uint32_t a0 = pack_bf16(sc[0][0], sc[0][1]);
    const uint32_t a2 = pack_bf16(sc[1][0], sc[1][1]);
#pragma unroll
    for (int d16 = 0; d16 < 8; ++d16) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, rows.v(d16));
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float* o = acc[2 * d16 + t];
        o[0] *= alpha;
        o[1] *= alpha;
        mma_bf16(o, a0, 0u, a2, 0u, bv[2 * t], bv[2 * t + 1]);
      }
    }
  }

  // The warp's partial of its G heads: numerators into part[g * D + d]
  // (f32) and (m, l) into wm[g], wl[g].
  template <int G>
  __device__ __forceinline__ void store(float* part, float* wm,
                                        float* wl) const {
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
    if (gid < G) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        part[gid * 128 + 8 * j + 2 * tig] = acc[j][0];
        part[gid * 128 + 8 * j + 2 * tig + 1] = acc[j][1];
      }
      if (tig == 0) {
        wm[gid] = m;
        wl[gid] = l;
      }
    }
  }
};

}  // namespace qt
