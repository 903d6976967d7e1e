// Paged flash-decode body shared by the dense and the sparse decode
// kernels: one CTA attends the G query heads of one (batch row,
// selection head) over one split of its pages and writes an
// unnormalised partial (acc, m, l); a second kernel merges the splits
// by their log-sum-exp. The split takes the place of the TPU kernels'
// sequential grid axis, which carried m/l/acc from step to step.
//
// Numerics follow the JAX kernels: the un-scaled q (bf16 or f32) is
// multiplied by the softmax scale in f32 and rounded to the pool dtype
// (bf16 for an fp8 pool) before QK; scores and the softmax run in f32
// with the finite mask value -1e30; p is rounded the same way before the
// PV product, which accumulates in f32; the sum l uses the unrounded p.
// fp8 pages are read with the upcast_fp8 recipe (common.cuh), each K/V
// tile widened to bf16 as it is stored to shared memory, so the products
// run as over a bf16 pool.
#pragma once

#include "common.cuh"

namespace qt {

constexpr int kD = 128;        // head dim the decode kernels take
constexpr int kThreads = 128;  // thread t owns output dim t in PV

struct DecodeArgs {
  const void* q;         // [B, Hsel*G, D] un-scaled, bf16 or f32
  const void* kv;        // one layer of the pool [Hkv, NP, 2, page, D]
  const int* tab;        // [B, NB]
  const int* seq_lens;   // [B]
  const int* indices;    // sparse: [B, Hsel, S] logical page ids
  const int* num_valid;  // sparse: [B]
  float* part_o;         // [B, Hsel, nsplit, G, D]
  float* part_ml;        // [B, Hsel, nsplit, G, 2]
  int Hsel, kvdiv, NP, page, NB, bpp, S, nsplit, per_split;
  float sm_scale;
  int q_bf16;            // q dtype: 1 = bf16, 0 = f32
};

// One CTA = (split, selection head, batch row). A split covers
// ``per_split`` consecutive pages (dense) or selection slots (sparse).
template <typename T, int G, bool kSparse>
__global__ void __launch_bounds__(kThreads)
decode_partial(DecodeArgs a) {
  using S = typename TileElem<T>::type;              // tile element
  constexpr int GCH = Elem<T>::kPerChunk;            // pool elements per 16 B
  constexpr int GCPR = kD / GCH;                     // pool chunks per row
  constexpr int CH = Elem<S>::kPerChunk;             // tile elements per 16 B
  constexpr int CPR = kD / CH;                       // tile chunks per row
  constexpr int TT = sizeof(S) == 2 ? 64 : 32;       // tokens per tile
  constexpr int KSTR = kD + CH;                      // padded K row

  __shared__ __align__(16) S ks[TT * KSTR];
  __shared__ __align__(16) S vs[TT * kD];
  __shared__ float qs[G][kD];
  __shared__ float ps[G][TT];
  __shared__ float m_s[G], l_s[G], alpha_s[G];
  __shared__ int64_t rowoff[TT];
  __shared__ int valid_s[TT];

  const int split = blockIdx.x, hsel = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* kv = static_cast<const T*>(a.kv);
  const int page = a.page;
  const int seq_len = a.seq_lens[b];
  const int h_kv = hsel / a.kvdiv;
  const int n_items = kSparse ? min(a.num_valid[b], a.S)
                              : (seq_len + page - 1) / page;
  const int first = split * a.per_split;
  const int ntok = max(0, min(first + a.per_split, n_items) - first) * page;

  const int64_t qbase = (static_cast<int64_t>(b) * a.Hsel + hsel) * G * kD;
  for (int i = tid; i < G * kD; i += kThreads) {
    const float x =
        a.q_bf16
            ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[qbase + i])
            : static_cast<const float*>(a.q)[qbase + i];
    qs[i / kD][i % kD] = Elem<S>::round(x * a.sm_scale);
  }
  if (tid < G) {
    m_s[tid] = QT_MASK_VALUE;
    l_s[tid] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < ntok; t0 += TT) {
    // Where each token of the tile lives, and whether it is real.
    if (tid < TT) {
      const int t = t0 + tid;
      int64_t off = -1;
      int valid = 0;
      if (t < ntok) {
        const int item = first + t / page, e = t % page;
        const int lp = kSparse
            ? a.indices[(static_cast<int64_t>(b) * a.Hsel + hsel) * a.S + item]
            : item;
        off = kv_row(h_kv, phys_page(a.tab, b, a.NB, a.bpp, lp), e, a.NP,
                     page, kD);
        valid = lp * page + e < seq_len;
      }
      rowoff[tid] = off;
      valid_s[tid] = valid;
    }
    __syncthreads();

    // K and V rows, 16 bytes of the pool a thread; rows past the split
    // read zeros.
    for (int c = tid; c < TT * GCPR; c += kThreads) {
      const int r = c / GCPR, cc = c % GCPR;
      const int64_t off = rowoff[r];
      uint4 kk = make_uint4(0, 0, 0, 0), vv = kk;
      if (off >= 0) {
        kk = __ldg(reinterpret_cast<const uint4*>(kv + off) + cc);
        vv = __ldg(reinterpret_cast<const uint4*>(kv + off + page * kD) + cc);
      }
      store_tile_chunk<T>(&ks[r * KSTR + cc * GCH], kk);
      store_tile_chunk<T>(&vs[r * kD + cc * GCH], vv);
    }
    __syncthreads();

    // Scores: one (head, token) pair per thread and step.
    for (int i = tid; i < G * TT; i += kThreads) {
      const int g = i / TT, r = i % TT;
      const S* krow = &ks[r * KSTR];
      float s = 0.f;
#pragma unroll 4
      for (int c = 0; c < CPR; ++c) {
        float f[CH];
        Elem<S>::unpack(*reinterpret_cast<const uint4*>(krow + c * CH), f);
#pragma unroll
        for (int j = 0; j < CH; ++j) s = fmaf(qs[g][c * CH + j], f[j], s);
      }
      ps[g][r] = valid_s[r] ? s : QT_MASK_VALUE;
    }
    __syncthreads();

    // Online softmax, one warp per head.
    for (int g = warp; g < G; g += kThreads / 32) {
      const float m_prev = m_s[g];
      float mx = QT_MASK_VALUE;
      for (int r = lane; r < TT; r += 32) mx = fmaxf(mx, ps[g][r]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < TT; r += 32) {
        const float p = valid_s[r] ? expf(ps[g][r] - m_new) : 0.f;
        sum += p;
        ps[g][r] = Elem<S>::round(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV: thread tid owns output dim tid for every head.
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= alpha_s[g];
    for (int r = 0; r < TT; ++r) {
      const float v = Elem<S>::to_float(vs[r * kD + tid]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(ps[g][r], v, acc[g]);
    }
    __syncthreads();
  }

  const int64_t part = (static_cast<int64_t>(b) * a.Hsel + hsel) * a.nsplit + split;
#pragma unroll
  for (int g = 0; g < G; ++g) a.part_o[(part * G + g) * kD + tid] = acc[g];
  if (tid < G) {
    a.part_ml[(part * G + tid) * 2] = m_s[tid];
    a.part_ml[(part * G + tid) * 2 + 1] = l_s[tid];
  }
}

// All-reduce of one value over the CTA (max or sum), through `red`.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w)
    v = kMax ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();
  return v;
}

// Merge the splits of one query head: grid (G, Hsel, B), dynamic
// shared memory of nsplit floats. The threads share out the splits to
// find the largest m and each split's weight exp(m_j - M); then thread d
// sums the weighted partials of output dim d. Empty splits carry
// m = -1e30, l = 0 and weigh nothing.
template <int G>
__global__ void __launch_bounds__(kThreads)
decode_merge(const float* part_o, const float* part_ml, float* out,
             int Hsel, int nsplit) {
  extern __shared__ float w_s[];
  __shared__ float red[kThreads / 32];
  const int g = blockIdx.x, hsel = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int64_t base = (static_cast<int64_t>(b) * Hsel + hsel) * nsplit;
  float mx = QT_MASK_VALUE;
  for (int j = tid; j < nsplit; j += kThreads)
    mx = fmaxf(mx, part_ml[((base + j) * G + g) * 2]);
  const float M = block_reduce<true>(mx, red);
  float den = 0.f;
  for (int j = tid; j < nsplit; j += kThreads) {
    const float w = expf(part_ml[((base + j) * G + g) * 2] - M);
    w_s[j] = w;
    den += w * part_ml[((base + j) * G + g) * 2 + 1];
  }
  den = block_reduce<false>(den, red);     // also publishes w_s
  float num = 0.f;
#pragma unroll 4
  for (int j = 0; j < nsplit; ++j)
    num += w_s[j] * part_o[((base + j) * G + g) * kD + tid];
  out[((static_cast<int64_t>(b) * Hsel + hsel) * G + g) * kD + tid] =
      den > 0.f ? num / den : 0.f;
}

template <typename T, int G, bool kSparse>
cudaError_t launch_decode(const DecodeArgs& a, float* out, int B,
                          cudaStream_t stream) {
  dim3 grid(a.nsplit, a.Hsel, B);
  decode_partial<T, G, kSparse><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge<G><<<dim3(G, a.Hsel, B), kThreads, a.nsplit * sizeof(float),
                     stream>>>(a.part_o, a.part_ml, out, a.Hsel, a.nsplit);
  return cudaGetLastError();
}

// Dispatch on the pool dtype code (common.cuh with_elem) and the group
// size G in {1, 2, 4, 8}.
template <bool kSparse>
int dispatch_decode(const DecodeArgs& a, float* out, int B, int G,
                    int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define QT_CASE(GG)                                                  \
  case GG:                                                           \
    err = with_elem(kv_dtype, [&](auto t) {                          \
      return launch_decode<decltype(t), GG, kSparse>(a, out, B, s);  \
    });                                                              \
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

}  // namespace qt
