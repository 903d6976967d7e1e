// Page-copy bandwidth probe: every page of a bf16 pool copied into shared
// memory in the order of a page list, one bulk async copy a page.
//
// Replaces the Pallas kernels of exp/gather_ab.py (kernel :56,
// pallas_call :88) and exp/dma_probe.py (kernel :60, pallas_call :111).
// With idx the page order (a random permutation to gather, the identity
// for a contiguous stream), q [8, 128] f32 and x bf16 seen as
// [npages, PAGE / 128, 128], both compute
//   out = q + 1e-6 * sum_c x[idx[c * ppc], :8, :]      (f32 sums)
// over the chunks c of ppc pages, while the copies themselves are what
// the probe times: the sum only keeps the copies live, since every byte
// a bulk copy moves must arrive before its barrier completes, read or
// not (plain loads whose values go unused may be dropped; bulk copies
// never are).
//
// Bound on the H100: bytes, the whole pool once at 3.35 TB/s.
//
// Design. The TPU ran one core through a ring of nslot 1 MB chunks in
// VMEM. Here the chunks are cut into stages of pps pages (at most
// ops/copy_probe.py STAGE_BYTES = 64 KB), and the stages are dealt out in
// contiguous runs to many CTAs (one per SM by default). Each CTA keeps an
// nslot-stage ring in shared memory: thread 0 issues one
// cp.async.bulk (global -> shared, completing on an mbarrier) a page, or
// one a semaphore share for a contiguous stream; each stage completes on
// nsem mbarriers, each expecting the bytes of a contiguous share of its
// pages (the counterpart of make_async_copy with nsem DMA semaphores a
// slot). All threads wait for a stage, add rows 0..7 of its first page
// when the stage opens a chunk, and thread 0 refills the slot. Each CTA
// writes its partial sum; a second launch adds the partials in CTA order,
// so the output does not depend on timing.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // 8 of the 1024 summed values a thread
constexpr int kRows = 8 * 128;  // x[page, :8, :], elements
constexpr int kMaxSlots = 8;
constexpr int kMaxSem = 8;

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

struct ProbeArgs {
  const int* idx;           // [npages] page order
  const __nv_bfloat16* x;   // [npages, page_elems]
  float* part;              // [gridDim.x, kRows]
  int page_elems, ppc, pps, nsem, nslot, nstage, per_cta, contig;
};

__global__ void __launch_bounds__(kThreads) copy_probe_kernel(ProbeArgs a) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t bars[kMaxSlots * kMaxSem];
  const int tid = threadIdx.x;
  const int first = blockIdx.x * a.per_cta;
  const int n = min(a.per_cta, a.nstage - first);
  const uint32_t page_bytes = a.page_elems * 2;
  const int share = a.pps / a.nsem;                 // pages a barrier
  const size_t slot_bytes = static_cast<size_t>(a.pps) * page_bytes;

  // Thread 0: local stage t into its slot, nsem barriers of share pages.
  auto issue = [&](int t) {
    const int slot = t % a.nslot;
    const int p0 = (first + t) * a.pps;             // position in idx
    unsigned char* dst = ring + slot * slot_bytes;
    for (int s = 0; s < a.nsem; ++s) {
      uint64_t* bar = &bars[slot * kMaxSem + s];
      bar_expect(bar, share * page_bytes);
      if (a.contig) {
        bulk_g2s(dst + s * share * page_bytes,
                 a.x + static_cast<int64_t>(a.idx[p0 + s * share]) *
                           a.page_elems,
                 share * page_bytes, bar);
      } else {
        for (int i = s * share; i < (s + 1) * share; ++i)
          bulk_g2s(dst + i * page_bytes,
                   a.x + static_cast<int64_t>(a.idx[p0 + i]) * a.page_elems,
                   page_bytes, bar);
      }
    }
  };

  if (tid == 0) {
    for (int i = 0; i < a.nslot * a.nsem; ++i)
      bar_init(&bars[(i / a.nsem) * kMaxSem + i % a.nsem], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(a.nslot, n); ++t) issue(t);

  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int t = 0; t < n; ++t) {
    const int slot = t % a.nslot;
    const uint32_t parity = (t / a.nslot) & 1;
    for (int s = 0; s < a.nsem; ++s) bar_wait(&bars[slot * kMaxSem + s], parity);
    if ((first + t) * a.pps % a.ppc == 0) {         // the stage opens a chunk
      float f[8];
      Elem<__nv_bfloat16>::unpack(
          *reinterpret_cast<const uint4*>(ring + slot * slot_bytes + tid * 16),
          f);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] += f[j];
    }
    __syncthreads();                                // the slot is read
    if (tid == 0 && t + a.nslot < n) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(t + a.nslot);
    }
  }
  float* dst = a.part + static_cast<int64_t>(blockIdx.x) * kRows + tid * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[j] = acc[j];
}

// out[e] = q[e] + 1e-6 * sum over the CTAs' partials, in CTA order.
__global__ void copy_probe_reduce(const float* part, const float* q,
                                  float* out, int nctas) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kRows) return;
  float acc = 0.f;
  for (int c = 0; c < nctas; ++c) acc += part[static_cast<int64_t>(c) * kRows + e];
  out[e] = q[e] + acc * 1e-6f;
}

}  // namespace

// idx [npages] int32; q, out [8, 128] f32; x [npages, page_elems] bf16;
// part [nctas, 1024] f32 scratch. The wrapper (ops/copy_probe.py
// stage_plan) picks pps, per_cta and nctas.
extern "C" int copy_probe_launch(const int* idx, const float* q,
                                 const void* x, float* part, float* out,
                                 int page_elems, int ppc, int pps, int nsem,
                                 int nslot, int nstage, int per_cta, int nctas,
                                 int contig, void* stream) {
  if (nslot < 1 || nslot > kMaxSlots || nsem < 1 || nsem > kMaxSem ||
      pps % nsem != 0 || page_elems % 128 != 0 || page_elems < kRows ||
      nctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(nslot) * pps * page_elems * 2;
  cudaError_t err = cudaFuncSetAttribute(
      copy_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ProbeArgs a{idx,  static_cast<const __nv_bfloat16*>(x),
              part, page_elems, ppc, pps, nsem, nslot, nstage, per_cta,
              contig};
  copy_probe_kernel<<<nctas, kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  copy_probe_reduce<<<kRows / kThreads, kThreads, 0, s>>>(part, q, out, nctas);
  return static_cast<int>(cudaGetLastError());
}
