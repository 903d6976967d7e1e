// Exact top-K page selection with ascending compaction, on its own.
//
// Replaces the select stage of quest_tpu/ops/fused_decode.py
// (_exact_topk_select + _compact_ids), which exp/select_compile.py wraps
// in a pallas_call of its own (line 48, kernel :34). One CTA per row:
// the row's first num_pages scores become order-preserving keys in
// shared memory (the last page's key is +inf; pages >= num_pages are
// never selected, as -inf in JAX), the radix select and the page-order
// compaction of select_common.cuh -- the fused decode kernel's own device
// code -- pick min(K, num_pages) pages, and slots past them hold page 0
// (in range, as JAX's compaction leaves them).
//
// Bound on the H100: bytes, but far below any launch: 4 bytes a score in,
// 4 bytes a selected id out (131 KB and 66 KB for 16 rows of 2048 pages
// at K = 128). The kernel's time is its serial chain: the key loads, four
// histogram passes of three CTA barriers each, a counting pass and a
// writing pass.
#include "select_common.cuh"

namespace qt {

__global__ void __launch_bounds__(kSelThreads)
topk_select_kernel(const float* scores, const int* num_pages, int* ids,
                   int* num_valid, int P, int K) {
  extern __shared__ unsigned keys[];  // [P]
  __shared__ SelectShared sm;
  const int r = blockIdx.x;
  const int n = min(max(num_pages[r], 0), P);
  const int k = min(K, n);
  const float* row = scores + static_cast<int64_t>(r) * P;
  int* out = ids + static_cast<int64_t>(r) * K;
  // Keys, with kBatch loads in flight a thread.
  constexpr int kBatch = 8;
  for (int p0 = 0; p0 < n; p0 += kBatch * blockDim.x) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * blockDim.x + threadIdx.x;
      v[u] = p < n ? __ldg(row + p) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int p = p0 + u * blockDim.x + threadIdx.x;
      if (p < n) keys[p] = p == n - 1 ? kKeyPosInf : order_key(v[u]);
    }
  }
  for (int s = k + threadIdx.x; s < K; s += blockDim.x) out[s] = 0;
  if (threadIdx.x == 0) num_valid[r] = k;
  __syncthreads();
  if (k == 0) return;  // uniform over the CTA
  radix_select(keys, n, static_cast<unsigned>(k), sm);
  compact_selected(keys, n, sm.thr, sm.ties, out, K, sm);
}

}  // namespace qt

// scores [R, P] f32; num_pages [R] int32; ids [R, K] int32 (out);
// num_valid [R] int32 (out).
extern "C" int topk_select_launch(const float* scores, const int* num_pages,
                                  int* ids, int* num_valid, int R, int P,
                                  int K, void* stream) {
  const size_t smem = static_cast<size_t>(P) * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      qt::topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  qt::topk_select_kernel<<<R, qt::kSelThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      scores, num_pages, ids, num_valid, P, K);
  return static_cast<int>(cudaGetLastError());
}
