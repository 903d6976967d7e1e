// Sparse experts of a decode step: the router, and the experts' SwiGLU
// products over the experts that some row picked.
//
// No Pallas counterpart: the JAX package has no experts. The port's
// plain version is ops/moe.py:moe_route_plain and moe_experts_plain.
//
// moe_route_kernel: one CTA a token row. The router's logits x . W[:, e]
// in f32 (bf16 products exact, f32 sums; 64 threads a group over the
// experts, 4 groups over the hidden dim, summed in group order), their
// softmax, the k largest (ties: the lower expert id) and their weights,
// renormalised to sum 1. Writes ids [N, k] int32, wts [N, k]. Over more
// than kStepRows rows (a prefill chunk) the same code runs as
// moe_route_chunk_kernel.
//
// moe_gate_up_kernel / moe_down_kernel: a CTA an (expert, column tile).
// It lists the (row, slot) pairs of the active rows that picked its
// expert; a CTA whose expert no row picked exits before it reads a
// weight, so a step reads each picked expert once and no other. The
// weight tile streams in 16-byte pieces (thread: 8 columns), the 8 warps
// splitting the rows of the product, each pass over the tile serving up
// to kTok pairs from shared memory; the warps' partials meet in a tree
// in shared memory, in a fixed order. gate_up writes the pair's SiLU
// product act = silu(g) * u with ops/silu_mul.py's roundings (g and u
// rounded to bf16, silu rounded, the product rounded); down writes the
// pair's expert output y, rounded to bf16. The router's weighted sum of a
// row's k outputs is left to ops/moe.py. CTA (e, 0) of gate_up adds 1 to
// *counter when it runs: the distinct experts read.
//
// Bound on the H100: bytes. At 8 rows of Mellum2 (hidden 2304, experts
// of width 896, 8 a token) the rows pick ~42 of 64 experts a layer under
// uniform routing: 42 x 3 x 2304 x 896 x 2 bytes = 520 MB a layer.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTok = 8;           // pairs a pass over a weight tile
constexpr int kMaxPairs = 1024;   // pairs a launch (rows x k)
constexpr int kStepRows = 16;     // a step's rows (ops/moe.py:KERNEL_ROWS)
constexpr int kGateCols = 128;    // gate columns (and up columns) a CTA
constexpr int kDownCols = 256;    // output columns a CTA

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack8(uint4 w, float f[8]) {
  const bf16* h = reinterpret_cast<const bf16*>(&w);
#pragma unroll
  for (int c = 0; c < 8; ++c) f[c] = bf(h[c]);
}

// The pairs (row * k + slot) of active rows whose slot picked expert e,
// in ascending order, into pairs[]; returns their count.
__device__ int list_pairs(const int* ids, const unsigned char* active, int N,
                          int K, int e, int* pairs, int* count) {
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < N * K; p += kThreads)
    if (ids[p] == e && (active == nullptr || active[p / K])) {
      const int at = atomicAdd(count, 1);
      pairs[at] = p;
    }
  __syncthreads();
  const int n = *count;
  if (threadIdx.x == 0) {  // insertion sort: a fixed order for any race
    for (int i = 1; i < n; ++i) {
      const int v = pairs[i];
      int j = i - 1;
      for (; j >= 0 && pairs[j] > v; --j) pairs[j + 1] = pairs[j];
      pairs[j + 1] = v;
    }
  }
  __syncthreads();
  return n;
}

// Sum acc over the 8 warps into warp 0's registers: halves meet in
// shared memory (red: 4 x kTok x 256 floats), 4 + 4, 2 + 2, 1 + 1.
__device__ __forceinline__ void reduce_warps(float (&acc)[kTok][8],
                                             float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int half = kWarps / 2; half >= 1; half /= 2) {
    if (warp >= half && warp < 2 * half) {
#pragma unroll
      for (int t = 0; t < kTok; ++t)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          red[((warp - half) * kTok + t) * 256 + lane * 8 + c] = acc[t][c];
    }
    __syncthreads();
    if (warp < half) {
#pragma unroll
      for (int t = 0; t < kTok; ++t)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[t][c] += red[(warp * kTok + t) * 256 + lane * 8 + c];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void route_row(const bf16* __restrict__ x,
                                          const bf16* __restrict__ w,
                                          int* __restrict__ ids,
                                          float* __restrict__ wts, int H,
                                          int E, int K) {
  __shared__ float part[4][64];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int e = tid % 64, grp = tid / 64;
  float acc = 0.f;
  if (e < E) {
    const bf16* xr = x + static_cast<int64_t>(row) * H;
    for (int k = grp; k < H; k += 4) acc = fmaf(bf(xr[k]), bf(w[k * E + e]), acc);
  }
  part[grp][e] = acc;
  __syncthreads();
  if (tid >= 32) return;
  float l[2];
  bool taken[2] = {false, false};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ei = tid + 32 * h;
    l[h] = ei < E ? ((part[0][ei] + part[1][ei]) + part[2][ei]) + part[3][ei]
                  : -INFINITY;
    if (isnan(l[h])) l[h] = -INFINITY;  // every pick a real expert id
  }
  // The softmax's denominator cancels in the renormalised weights.
  float m = fmaxf(l[0], l[1]);
  for (int o = 16; o; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float sel = 0.f, mine = 0.f;
  int my_id = -1;
  for (int j = 0; j < K; ++j) {
    // The largest logit not yet taken (ties: the lower id).
    float bv = -INFINITY;
    int bi = E;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ei = tid + 32 * h;
      if (ei < E && !taken[h] && (l[h] > bv || (l[h] == bv && ei < bi))) {
        bv = l[h];
        bi = ei;
      }
    }
    for (int o = 16; o; o /= 2) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    const float eb = expf(bv - m);
    sel += eb;
    if (bi % 32 == tid) taken[bi / 32] = true;
    if (tid == j) {
      my_id = bi;
      mine = eb;
    }
  }
  if (tid < K) {
    ids[row * K + tid] = my_id;
    wts[row * K + tid] = mine / sel;
  }
}

// The same router under two names: a decode step's rows (at most
// kStepRows) and a prefill chunk's, so that a profile of the decode
// step's kernels leaves the chunks' routing out.
__global__ void __launch_bounds__(kThreads)
moe_route_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 int* __restrict__ ids, float* __restrict__ wts, int H,
                 int E, int K) {
  route_row(x, w, ids, wts, H, E, K);
}

__global__ void __launch_bounds__(kThreads)
moe_route_chunk_kernel(const bf16* __restrict__ x,
                       const bf16* __restrict__ w, int* __restrict__ ids,
                       float* __restrict__ wts, int H, int E, int K) {
  route_row(x, w, ids, wts, H, E, K);
}

__global__ void __launch_bounds__(kThreads)
moe_gate_up_kernel(const bf16* __restrict__ x, const int* __restrict__ ids,
                   const unsigned char* __restrict__ active,
                   const bf16* __restrict__ wg, const bf16* __restrict__ wu,
                   bf16* __restrict__ act, int* __restrict__ counter, int N,
                   int K, int H, int I) {
  extern __shared__ __align__(16) unsigned char dyn[];
  float* red = reinterpret_cast<float*>(dyn);                 // 32 KB
  bf16* xs = reinterpret_cast<bf16*>(red + 4 * kTok * 256);   // [kTok][H]
  __shared__ int pairs[kMaxPairs];
  __shared__ int count;
  const int e = blockIdx.x;
  const int n = list_pairs(ids, active, N, K, e, pairs, &count);
  if (n == 0) return;
  if (blockIdx.y == 0 && threadIdx.x == 0 && counter != nullptr)
    atomicAdd(counter, 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * kGateCols + (lane % 16) * 8;
  const bool colok = c0 < I;
  const bf16* W = (lane < 16 ? wg : wu) + static_cast<int64_t>(e) * H * I +
                  (colok ? c0 : 0);
  for (int t0 = 0; t0 < n; t0 += kTok) {
    const int nt = min(kTok, n - t0);
    for (int i = threadIdx.x; i < kTok * H; i += kThreads) {
      const int t = i / H, k = i % H;
      xs[i] = t < nt ? x[static_cast<int64_t>(pairs[t0 + t] / K) * H + k]
                     : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    float acc[kTok][8];
#pragma unroll
    for (int t = 0; t < kTok; ++t)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[t][c] = 0.f;
#pragma unroll 4
    for (int k = warp; k < H; k += kWarps) {
      const uint4 raw = colok
          ? __ldg(reinterpret_cast<const uint4*>(W + static_cast<int64_t>(k) * I))
          : make_uint4(0, 0, 0, 0);
      float wf[8];
      unpack8(raw, wf);
#pragma unroll
      for (int t = 0; t < kTok; ++t) {
        const float xv = bf(xs[t * H + k]);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[t][c] = fmaf(xv, wf[c], acc[t][c]);
      }
    }
    reduce_warps(acc, red);
    if (warp == 0) {
#pragma unroll
      for (int t = 0; t < kTok; ++t) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float u = __shfl_down_sync(0xffffffffu, acc[t][c], 16);
          if (lane < 16 && colok && t < nt) {
            // ops/silu_mul.py's roundings over bf16 g and u.
            const float g = round_bf16(acc[t][c]);
            const float s = round_bf16(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))));
            act[static_cast<int64_t>(pairs[t0 + t]) * I + c0 + c] =
                __float2bfloat16_rn(__fmul_rn(s, round_bf16(u)));
          }
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
moe_down_kernel(const bf16* __restrict__ act, const int* __restrict__ ids,
                const unsigned char* __restrict__ active,
                const bf16* __restrict__ wd, bf16* __restrict__ y, int N,
                int K, int H, int I) {
  extern __shared__ __align__(16) unsigned char dyn[];
  float* red = reinterpret_cast<float*>(dyn);                 // 32 KB
  bf16* as = reinterpret_cast<bf16*>(red + 4 * kTok * 256);   // [kTok][I]
  __shared__ int pairs[kMaxPairs];
  __shared__ int count;
  const int e = blockIdx.x;
  const int n = list_pairs(ids, active, N, K, e, pairs, &count);
  if (n == 0) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.y * kDownCols + lane * 8;
  const bool colok = c0 < H;
  const bf16* W = wd + static_cast<int64_t>(e) * I * H + (colok ? c0 : 0);
  for (int t0 = 0; t0 < n; t0 += kTok) {
    const int nt = min(kTok, n - t0);
    for (int i = threadIdx.x; i < kTok * I; i += kThreads) {
      const int t = i / I, k = i % I;
      as[i] = t < nt ? act[static_cast<int64_t>(pairs[t0 + t]) * I + k]
                     : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    float acc[kTok][8];
#pragma unroll
    for (int t = 0; t < kTok; ++t)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[t][c] = 0.f;
#pragma unroll 4
    for (int k = warp; k < I; k += kWarps) {
      const uint4 raw = colok
          ? __ldg(reinterpret_cast<const uint4*>(W + static_cast<int64_t>(k) * H))
          : make_uint4(0, 0, 0, 0);
      float wf[8];
      unpack8(raw, wf);
#pragma unroll
      for (int t = 0; t < kTok; ++t) {
        const float av = bf(as[t * I + k]);
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[t][c] = fmaf(av, wf[c], acc[t][c]);
      }
    }
    reduce_warps(acc, red);
    if (warp == 0 && colok) {
#pragma unroll
      for (int t = 0; t < kTok; ++t) {
        if (t >= nt) break;
        __align__(16) bf16 out[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) out[c] = __float2bfloat16_rn(acc[t][c]);
        *reinterpret_cast<uint4*>(y + static_cast<int64_t>(pairs[t0 + t]) * H +
                                  c0) = *reinterpret_cast<const uint4*>(out);
      }
    }
    __syncthreads();
  }
}

size_t tile_smem(int rows) {
  return 4 * kTok * 256 * sizeof(float) + static_cast<size_t>(kTok) * rows * 2;
}

}  // namespace

extern "C" int moe_route_launch(const void* x, const void* w, int* ids,
                                float* wts, int N, int H, int E, int K,
                                void* stream) {
  if (E > 64 || K > 32 || K > E || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = N > kStepRows ? moe_route_chunk_kernel : moe_route_kernel;
  kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), ids, wts, H,
      E, K);
  return static_cast<int>(cudaGetLastError());
}

// active: a bool per row, or null (every row). act [N * K, I], y [N * K,
// H]: rows of pairs that no CTA lists (inactive rows) are not written.
extern "C" int moe_experts_launch(const void* x, const int* ids,
                                  const void* active, const void* wg,
                                  const void* wu, const void* wd, void* act,
                                  void* y, int* counter, int N, int K, int H,
                                  int I, int E, void* stream) {
  if (N * K > kMaxPairs || H % 8 || I % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* on = static_cast<const unsigned char*>(active);
  const size_t s1 = tile_smem(H), s2 = tile_smem(I);
  cudaError_t err = cudaFuncSetAttribute(
      moe_gate_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(s1));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(moe_down_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(s2));
  if (err != cudaSuccess) return static_cast<int>(err);
  moe_gate_up_kernel<<<dim3(E, (I + kGateCols - 1) / kGateCols), kThreads, s1,
                       s>>>(static_cast<const bf16*>(x), ids, on,
                            static_cast<const bf16*>(wg),
                            static_cast<const bf16*>(wu),
                            static_cast<bf16*>(act), counter, N, K, H, I);
  moe_down_kernel<<<dim3(E, (H + kDownCols - 1) / kDownCols), kThreads, s2,
                    s>>>(static_cast<const bf16*>(act), ids, on,
                         static_cast<const bf16*>(wd), static_cast<bf16*>(y),
                         N, K, H, I);
  return static_cast<int>(cudaGetLastError());
}
