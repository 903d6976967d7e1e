// One warp's flash-decode attention over chunks of up to 16 tokens on the
// tensor cores, shared by the sparse and dense decode kernels
// (decode_common.cuh) and the fused decode kernel (fused_decode.cu).
//
// mma.sync m16n8k16 with the query heads of a group as the rows (G <= 8
// padded to 16, lane l holding head l / 4; or 16 heads, lane l holding
// heads l / 4 and l / 4 + 8): QK^T takes K^T as B (8 tokens a
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

// kHi: 16 head rows (lane l holds heads l / 4 and l / 4 + 8), for groups
// of 9-16 heads; otherwise 8 rows (the mma's rows 8-15 are zeros).
template <bool kHi = false>
struct WarpAttn {
  static constexpr int R = kHi ? 2 : 1;  // head rows a lane
  float m[R], l[R];    // head gid's (and gid + 8's) running maximum and sum
  float acc[16][4];    // head gid's output dims 8 j + 2 tig, + 1 in [0],
                       // [1]; head gid + 8's in [2], [3]
  uint32_t qa[8][2 * R];  // the lanes' query rows as mma A fragments

  // q0, q1: the lane's head rows gid and gid + 8 (f32 holding bf16
  // values), or null for a padded head (zeros).
  __device__ __forceinline__ void init(const float* q0,
                                       const float* q1 = nullptr) {
    const int tig = threadIdx.x & 3;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* qrow = r == 0 ? q0 : q1;
        const float* qr = qrow + kk * 16 + 2 * tig;
        qa[kk][2 * r] = qrow != nullptr ? pack_bf16(qr[0], qr[1]) : 0u;
        qa[kk][2 * r + 1] = qrow != nullptr ? pack_bf16(qr[8], qr[9]) : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = QT_MASK_VALUE;
      l[r] = 0.f;
    }
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
        mma_bf16(sc[j], qa[kk][0], kHi ? qa[kk][2] : 0u, qa[kk][1],
                 kHi ? qa[kk][3] : 0u, ld_u32(rows.k(j, kk, 0)),
                 ld_u32(rows.k(j, kk, 1)));
    }
    // Online softmax of head gid (and gid + 8) over the chunk's 16 tokens
    // (4 lanes hold them).
    float mx[R], sum[R], alpha[R];
#pragma unroll
    for (int r = 0; r < R; ++r) mx[r] = QT_MASK_VALUE;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = (valid >> (8 * j + 2 * tig + e)) & 1u;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float& v = sc[j][2 * r + e];
          v = ok ? v * s_mul : QT_MASK_VALUE;
          mx[r] = fmaxf(mx[r], v);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r]);  // the new maximum
      sum[r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float& v = sc[j][2 * r + e];
          const float pr = v == QT_MASK_VALUE ? 0.f : expf(v - mx[r]);
          sum[r] += pr;
          v = pr;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      alpha[r] = expf(m[r] - mx[r]);
      l[r] = alpha[r] * l[r] + sum[r];
      m[r] = mx[r];
    }
    const uint32_t a0 = pack_bf16(sc[0][0], sc[0][1]);
    const uint32_t a2 = pack_bf16(sc[1][0], sc[1][1]);
    const uint32_t a1 = kHi ? pack_bf16(sc[0][2], sc[0][3]) : 0u;
    const uint32_t a3 = kHi ? pack_bf16(sc[1][2], sc[1][3]) : 0u;
#pragma unroll
    for (int d16 = 0; d16 < 8; ++d16) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, rows.v(d16));
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        float* o = acc[2 * d16 + t];
        o[0] *= alpha[0];
        o[1] *= alpha[0];
        if (kHi) {
          o[2] *= alpha[R - 1];
          o[3] *= alpha[R - 1];
        }
        mma_bf16(o, a0, a1, a2, a3, bv[2 * t], bv[2 * t + 1]);
      }
    }
  }

  // The warp's partial of its G heads (G <= 8, or G = 16 with kHi):
  // numerators into part[g * D + d] (f32) and (m, l) into wm[g], wl[g].
  template <int G>
  __device__ __forceinline__ void store(float* part, float* wm,
                                        float* wl) const {
    static_assert(kHi ? G == 16 : G <= 8, "rows of the warp's heads");
    const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int g = gid + 8 * r;
      if (g < G) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          part[g * 128 + 8 * j + 2 * tig] = acc[j][2 * r];
          part[g * 128 + 8 * j + 2 * tig + 1] = acc[j][2 * r + 1];
        }
        if (tig == 0) {
          wm[g] = m[r];
          wl[g] = l[r];
        }
      }
    }
  }
};

}  // namespace qt
