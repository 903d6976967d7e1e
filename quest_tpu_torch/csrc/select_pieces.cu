// The seven select pieces of the fused kernel's top-K stage, one at a
// time, over s [SG, 16, 128] f32.
//
// Replaces the Pallas kernel of exp/select_compile2.py (kernel :23,
// pallas_call :73), a probe that bisected which of these pieces the TPU
// compiler took at SG > 1. Each stage computes what that kernel computes
// for its STAGE:
//   0 reduce3  out = s + sum(s[g])                      (per group g)
//   1 cumsum   out = inclusive cumsum of int(s[g]) in row-major order
//              (quest_tpu/ops/fused_decode.py:_band_cumsum, one 16-row
//              band a group)
//   2 full     out = s + 5
//   3 radix    two bits (31, 30) of the exact select's descent over the
//              order-preserving keys b < 0 ? b ^ 0x7fffffff : b of s's
//              bits, k_rem = 128 at the start; out = the active mask
//   4 thr      key = int(s); thr = max of the keys > 3 (INT_MIN if none);
//              out = key > thr
//   5 slice2d  out = s + s[g, r, 127] (each row's last lane)
//   6 dot2d    out = s + sum_{i < r} s[g, i, 127]       (strict prefix)
// Integers are int32, int(x) truncates toward zero, as astype does.
//
// Bound on the H100: bytes (s read once, out written once, 16 KB a
// group), far below a launch at these sizes. Design: one CTA a group of
// 128 threads; thread t holds column t of the 16 rows in registers, so a
// row is one CTA-wide scan or reduction and the last lane is thread 127.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kR = 16, kL = 128, kWarps = kL / 32;

// CTA-wide sum or max of one value a thread; every thread gets it.
template <typename V, bool kMax>
__device__ __forceinline__ V cta_reduce(V v, V* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const V w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? max(v, w) : v + w;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = kMax ? max(v, red[w]) : v + red[w];
  __syncthreads();
  return v;
}

template <int STAGE>
__global__ void __launch_bounds__(kL) select_pieces_kernel(const float* s,
                                                           float* o) {
  __shared__ float red_f[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int warp_tot[kR][kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* in = s + static_cast<int64_t>(blockIdx.x) * kR * kL;
  float* out = o + static_cast<int64_t>(blockIdx.x) * kR * kL;
  float v[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) v[r] = in[r * kL + t];

  if constexpr (STAGE == 0) {                       // reduce3
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kR; ++r) a += v[r];
    a = cta_reduce<float, false>(a, red_f);
#pragma unroll
    for (int r = 0; r < kR; ++r) out[r * kL + t] = v[r] + a;
  } else if constexpr (STAGE == 1) {                // cumsum
    int x[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      x[r] = __float2int_rz(v[r]);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {            // inclusive, in the warp
        const int y = __shfl_up_sync(0xffffffffu, x[r], d);
        if (lane >= d) x[r] += y;
      }
      if (lane == 31) warp_tot[r][warp] = x[r];
    }
    __syncthreads();
    int base = 0;                                   // rows above, then warps
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      int before = 0, row = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        before += w < warp ? warp_tot[r][w] : 0;
        row += warp_tot[r][w];
      }
      out[r * kL + t] = static_cast<float>(base + before + x[r]);
      base += row;
    }
  } else if constexpr (STAGE == 2) {                // full
#pragma unroll
    for (int r = 0; r < kR; ++r) out[r * kL + t] = v[r] + 5.f;
  } else if constexpr (STAGE == 3) {                // radix
    int key[kR], active[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int b = __float_as_int(v[r]);
      key[r] = b < 0 ? b ^ 0x7fffffff : b;
      active[r] = 1;
    }
    int k_rem = 128;
    for (int sh = 31; sh > 29; --sh) {
      int hi[kR], c = 0;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int bit = (static_cast<unsigned>(key[r]) >> sh) & 1;
        const int bit_hi = sh == 31 ? 1 - bit : bit;
        hi[r] = active[r] * bit_hi;
        c += hi[r];
      }
      c = cta_reduce<int, false>(c, red_i);
      const bool go_hi = c >= k_rem;
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int bit = (static_cast<unsigned>(key[r]) >> sh) & 1;
        const int bit_hi = sh == 31 ? 1 - bit : bit;
        active[r] = go_hi ? hi[r] : active[r] * (1 - bit_hi);
      }
      k_rem = go_hi ? k_rem : k_rem - c;
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) out[r * kL + t] = static_cast<float>(active[r]);
  } else if constexpr (STAGE == 4) {                // thr
    int m = INT_MIN;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int key = __float2int_rz(v[r]);
      if (key > 3) m = max(m, key);
    }
    const int thr = cta_reduce<int, true>(m, red_i);
#pragma unroll
    for (int r = 0; r < kR; ++r)
      out[r * kL + t] = __float2int_rz(v[r]) > thr ? 1.f : 0.f;
  } else {                                          // slice2d, dot2d
    float off = 0.f;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float last = in[r * kL + kL - 1];
      out[r * kL + t] = v[r] + (STAGE == 5 ? last : off);
      off += last;
    }
  }
}

template <int STAGE>
cudaError_t launch(const float* s, float* o, int SG, cudaStream_t st) {
  select_pieces_kernel<STAGE><<<SG, kL, 0, st>>>(s, o);
  return cudaGetLastError();
}

}  // namespace

// s, out [SG, 16, 128] f32; stage 0..6 as listed above.
extern "C" int select_pieces_launch(const float* s, float* out, int SG,
                                    int stage, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return static_cast<int>(launch<0>(s, out, SG, st));
    case 1: return static_cast<int>(launch<1>(s, out, SG, st));
    case 2: return static_cast<int>(launch<2>(s, out, SG, st));
    case 3: return static_cast<int>(launch<3>(s, out, SG, st));
    case 4: return static_cast<int>(launch<4>(s, out, SG, st));
    case 5: return static_cast<int>(launch<5>(s, out, SG, st));
    case 6: return static_cast<int>(launch<6>(s, out, SG, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
