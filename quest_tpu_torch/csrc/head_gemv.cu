// The lm_head product of a decode step: f32 x times a bf16 head, in f32.
//
// No Pallas counterpart: it replaces the dot that the JAX package compiles
// quest_tpu/models/llama.py:329 qdot(x.astype(f32), params["lm_head"],
// dtype=f32) into, where XLA widens the bf16 head inside the dot's operand
// read. The port kept an f32 copy of the head and ran an f32 cuBLAS GEMV
// over it, which carried twice the head's bytes in memory and read twice
// them a step; torch.matmul takes no f32-by-bf16 product. Here each bf16
// weight is widened exactly (its bits shifted into an f32) as it is read,
// and the products are f32 FMAs on the CUDA cores, as full f32 as JAX's
// (no tensor cores, no TF32).
//
// x [M <= 16, K] f32, w [K, N] bf16 row-major (N contiguous), out [M, N]
// f32; any K and N. Grid (tiles, ksplit): a CTA owns a tile of 256 output
// columns and a split of `chunk` rows of w. A thread owns 8 columns (one
// 16-byte piece of a w row) and every 8th row of the split; the 32 threads
// of a warp read 512 contiguous bytes of a row, so each load is whole
// lines. Each thread keeps kU loads in flight (loaded with the streaming
// hint: w is read once) while it works on the previous kU rows. x's slice
// of the split is staged in shared memory once, rows past M as zeros (M is
// rounded up to MT, 1, 2, 4, 8 or 16). The 8 row lanes of a column are
// summed through shared memory in lane order; with ksplit > 1 each CTA
// stores its f32 partial and the last CTA of a tile to take a ticket adds
// the splits in split order and resets the ticket (as csrc/qgemv.cu's
// qgemv_kernel does), so a call's sums always run in the same order.
// Rows of w whose width or address is not 16-byte aligned are read an
// element at a time, and columns past N are zero.
//
// Bound on the H100: bytes. The head read once: Llama-3.1-8B's 4096 x
// 128256 bf16 is 1.05 GB, 0.314 ms at 3.35 TB/s; the 2 M K N FMAs
// (~2 GFLOP at M = 2) are far below the f32 peak. The plan
// (ops/head_gemv.py:head_gemv_plan) is a pure function of the shapes and
// the SM count.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 8;                       // columns a thread
constexpr int kColThreads = 32;                // threads across a tile
constexpr int kTileN = kCols * kColThreads;    // 256 columns a CTA
constexpr int kRL = kThreads / kColThreads;    // 8 row lanes
constexpr int kU = 4;                          // loads in flight

// 8 bf16 weights at p, of which `valid` (1..8) lie inside the row; zeros
// past it. One 16-byte load where the row allows (`vec`).
__device__ __forceinline__ uint4 ld_w8(const __nv_bfloat16* p, bool vec,
                                       int valid) {
  if (vec) return __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  unsigned v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < kCols; ++e)
    if (e < valid)
      v[e / 2] |= static_cast<unsigned>(__ldg(s + e)) << (16 * (e % 2));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// CTAs an SM by rows of x (registers: 64, 72, 91 and more on the card),
// as ops/head_gemv.py:CTAS_PER_SM models them.
__host__ __device__ constexpr int ctas_per_sm(int mt) {
  return mt <= 1 ? 4 : mt <= 2 ? 3 : mt <= 4 ? 2 : 1;
}

template <int MT>
__global__ void __launch_bounds__(kThreads, ctas_per_sm(MT))
head_gemv_kernel(const float* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
                 float* __restrict__ part, int* __restrict__ tickets, int M,
                 int K, int N, int chunk, int ksplit, bool vec) {
  extern __shared__ __align__(16) float sm[];   // x slice, then row lanes
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int c = tid % kColThreads;
  const int r = tid / kColThreads;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int n0 = tile * kTileN;
  const int col = n0 + c * kCols;
  const int ncol = N - col;                    // the thread's columns in out
  const bool col_ok = ncol > 0;
  const bool whole = vec && ncol >= kCols;
  const int kbeg = split * chunk;
  const int nrow = min(K, kbeg + chunk) - kbeg;

  const __nv_bfloat16* wb = w + static_cast<int64_t>(kbeg) * N + col;
  uint4 cur[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int kk = r + u * kRL;
    cur[u] = (col_ok && kk < nrow)
                 ? ld_w8(wb + static_cast<int64_t>(kk) * N, whole, ncol)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  for (int i = tid; i < MT * nrow; i += kThreads) {
    const int m = i / nrow, kk = i % nrow;
    sm[i] = m < M ? x[static_cast<int64_t>(m) * K + kbeg + kk] : 0.f;
  }
  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[m][e] = 0.f;

  __syncthreads();  // the x slice is staged
  for (int k0 = r; k0 < nrow; k0 += kU * kRL) {
    uint4 nxt[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = k0 + (kU + u) * kRL;
      nxt[u] = (col_ok && kk < nrow)
                   ? ld_w8(wb + static_cast<int64_t>(kk) * N, whole, ncol)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int kk = k0 + u * kRL;
      if (kk >= nrow) break;
      const unsigned wd[4] = {cur[u].x, cur[u].y, cur[u].z, cur[u].w};
      float wf[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) {             // bf16 -> f32, exact
        wf[2 * i] = __uint_as_float(wd[i] << 16);
        wf[2 * i + 1] = __uint_as_float(wd[i] & 0xFFFF0000u);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = sm[m * nrow + kk];
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[m][e] = fmaf(xv, wf[e], acc[m][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
  }

  // Sum the row lanes of each (row of x, column) in lane order.
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m >= M) break;                          // M is the CTA's own
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(sm + r * kTileN + c * kCols);
    dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
    __syncthreads();
    const int n = n0 + tid;                     // kThreads == kTileN
    if (n < N) {
      float v = 0.f;
#pragma unroll
      for (int rr = 0; rr < kRL; ++rr) v += sm[rr * kTileN + tid];
      if (ksplit == 1)
        out[static_cast<int64_t>(m) * N + n] = v;
      else
        part[(static_cast<int64_t>(split) * M + m) * N + n] = v;
    }
  }
  if (ksplit == 1) return;

  // The ticket merge: the last CTA of the tile adds every split's
  // partial in split order and leaves the ticket at zero.
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // the CTA's partials (ordered by the barrier) first
    is_last = atomicAdd(&tickets[tile], 1) == ksplit - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (tid == 0) tickets[tile] = 0;  // zero for the next launch
  const int64_t stride = static_cast<int64_t>(M) * N;
  for (int i = tid; i < M * kTileN; i += kThreads) {
    const int m = i / kTileN, n = n0 + i % kTileN;
    if (n >= N) continue;
    const float* p = part + static_cast<int64_t>(m) * N + n;
    float v = 0.f;
    for (int s = 0; s < ksplit; ++s) v += __ldcg(p + s * stride);
    out[static_cast<int64_t>(m) * N + n] = v;
  }
}

template <int MT>
cudaError_t launch(const float* x, const __nv_bfloat16* w, float* out,
                   float* part, int* tickets, int M, int K, int N, int chunk,
                   int ksplit, cudaStream_t stream) {
  const int tiles = (N + kTileN - 1) / kTileN;
  const size_t xs = static_cast<size_t>(MT) * chunk * sizeof(float);
  const size_t lanes = static_cast<size_t>(kRL) * kTileN * sizeof(float);
  const size_t smem = xs > lanes ? xs : lanes;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const bool vec = N % kCols == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  head_gemv_kernel<MT><<<dim3(tiles, ksplit), kThreads, smem, stream>>>(
      x, w, out, part, tickets, M, K, N, chunk, ksplit, vec);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] f32, w [K, N] bf16, out [M, N] f32, 1 <= M <= 16; w's rows cut
// into ksplit splits of chunk rows (ops/head_gemv.py:head_gemv_plan: chunk
// x M rounded up to a power of two within 48 KB of f32). part [ksplit, M,
// N] f32 and tickets [ceil(N / 256)] int32 (zero; left zero) when ksplit
// > 1, else NULL.
extern "C" int head_gemv_launch(const float* x, const void* w, float* out,
                                float* part, int* tickets, int M, int K,
                                int N, int chunk, int ksplit, void* stream) {
  if (M < 1 || M > 16 || K < 1 || N < 1 || chunk < 1 || ksplit < 1 ||
      static_cast<int64_t>(chunk) * ksplit < K ||
      static_cast<int64_t>(chunk) * (ksplit - 1) >= K ||
      (ksplit > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M <= 1)
    err = launch<1>(x, wb, out, part, tickets, M, K, N, chunk, ksplit, s);
  else if (M <= 2)
    err = launch<2>(x, wb, out, part, tickets, M, K, N, chunk, ksplit, s);
  else if (M <= 4)
    err = launch<4>(x, wb, out, part, tickets, M, K, N, chunk, ksplit, s);
  else if (M <= 8)
    err = launch<8>(x, wb, out, part, tickets, M, K, N, chunk, ksplit, s);
  else
    err = launch<16>(x, wb, out, part, tickets, M, K, N, chunk, ksplit, s);
  return static_cast<int>(err);
}
