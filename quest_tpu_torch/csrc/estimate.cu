// Streaming page-criticality estimate over logical per-page metadata.
//
// Replaces quest_tpu/ops/estimate.py:page_scores_kernel (the Pallas
// kernel _est_kernel, pallas_call at line 229): for each (batch row, KV
// head) and each of its P pages,
//   score = agg_g( relu(q_g) . k_max + min(q_g, 0) . k_min ),
// relu(q) and min(q, 0) rounded to the metadata dtype (bf16 for fp8
// metadata, read with the upcast_fp8 recipe), f32 products, the
// G query rows of the group aggregated by max or sum. The scoring device
// code is the fused decode kernel's (select_common.cuh).
//
// Bound on the H100: bytes. Every metadata row is read once (2 x 256 B
// a page in bf16), 16.8 MB for B=2, 8 KV heads and 2048 pages, against
// 3.35 TB/s; the products are 2 x G x D FMAs a page. The design gives
// each CTA 128 consecutive pages of one head (256 CTAs at that shape) so
// that the card is filled, keeps the G query rows in registers, and has
// every lane keep U pages' 16-byte loads in flight before it reduces.
#include "select_common.cuh"

namespace qt {

constexpr int kEstPagesPerCta = 128;

template <typename M, int G>
__global__ void __launch_bounds__(kSelThreads)
estimate_kernel(const void* q, const M* kmax, const M* kmin, float* out,
                int Hkv, int P, int agg_sum, int q_bf16) {
  // Pages a team keeps in flight: fewer for fp8, whose 16-element
  // chunks double the query registers of a lane.
  constexpr int U = (G >= 8 ? 2 : 8) / (sizeof(M) == 1 ? 2 : 1);
  const int h = blockIdx.y, b = blockIdx.z;
  const int lo = blockIdx.x * kEstPagesPerCta;
  const int hi = min(P, lo + kEstPagesPerCta);
  const int64_t head = static_cast<int64_t>(b) * Hkv + h;
  SplitQuery<M, G> sq;
  sq.load(q, q_bf16, head * G * kHeadDim,
          (threadIdx.x & 31) % SplitQuery<M, G>::kLanes);
  float* o = out + head * P;
  score_pages<M, G, U>(
      kmax, kmin, sq, lo, hi, agg_sum != 0,
      [&](int p) { return (head * P + p) * kHeadDim; },
      [&](int p, float s) { o[p] = s; });
}

template <typename M, int G>
cudaError_t launch_estimate(const void* q, const void* kmax, const void* kmin,
                            float* out, int B, int Hkv, int P, int agg_sum,
                            int q_bf16, cudaStream_t stream) {
  dim3 grid((P + kEstPagesPerCta - 1) / kEstPagesPerCta, Hkv, B);
  estimate_kernel<M, G><<<grid, kSelThreads, 0, stream>>>(
      q, static_cast<const M*>(kmax), static_cast<const M*>(kmin), out, Hkv,
      P, agg_sum, q_bf16);
  return cudaGetLastError();
}

}  // namespace qt

// q [B, Hkv*G, 128] bf16/f32; kmax, kmin [B, Hkv, P, 128] of dtype code
// meta_dtype (0 f32, 1 bf16, 2 fp8 e4m3); out [B, Hkv, P] f32.
extern "C" int estimate_launch(const void* q, const void* kmax,
                               const void* kmin, float* out, int B, int Hkv,
                               int G, int P, int meta_dtype, int agg_sum,
                               int q_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define QT_CASE(GG)                                                        \
  case GG:                                                                 \
    err = with_elem(meta_dtype, [&](auto t) {                              \
      return qt::launch_estimate<decltype(t), GG>(q, kmax, kmin, out, B,   \
                                                  Hkv, P, agg_sum, q_bf16, \
                                                  s);                      \
    });                                                                    \
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
