// RMSNorm with the residual add folded in, one launch a call.
//
// No Pallas counterpart: it replaces the XLA fusion that the JAX package
// compiles quest_tpu/ops/rms_norm.py:16 rms_norm into, with the residual
// add before it (quest_tpu/models/llama.py: x + o_proj, x + mlp), which
// the port ran as 9 plain PyTorch ops a norm and one a residual add
// (ops/rms_norm.py:rms_norm_plain). Numerics are HF LlamaRMSNorm's, op for
// op: h = (T)(x + res) (one f32 sum rounded to T, as torch adds two T
// tensors); var = sum(h * h) * (1 / H) in f32 (each square rounded to f32,
// as the plain version's x * x kernel rounds it; torch's mean multiplies
// its sum by the f32 factor 1 / H); r = 1 / sqrt(var + eps) (sqrt and
// division correctly rounded, as torch's kernels are); y = (T)(h * r);
// out = (T)(y * (T)w). Every product and sum goes through __fmul_rn /
// __fadd_rn, so nothing is contracted into an FMA. The one difference from
// the plain version is the order of the sum of squares: torch's reduction
// order depends on its launch configuration and is not repeated here, so
// var differs by a few f32 ulps and an output rounds the other way where
// h * r lands that close to a rounding boundary of T (ROADMAP note d).
// h is bit for bit the plain version's.
//
// x, res, out, h [rows, H] and w [H], of one dtype T (bf16 or f32). A CTA
// of 256 threads takes one row at a time (a grid-stride loop over rows):
// pass 1 reads x (and res) once in 16-byte pieces, writes h, keeps the
// first kCache pieces a thread owns in registers and sums their squares
// (a thread's pieces in order, then a butterfly in the warp, then the 8
// warps' sums in order, so every call sums in the same order); pass 2
// scales, re-reading from h (or x) only the pieces past kCache. Rows whose
// width or pointers are not 16-byte aligned take the same loops an element
// at a time.
//
// Bound on the H100: bytes. x (and res) read once, out (and h) written
// once, w read once: a decode step's 2 rows of 4096 bf16 move 34 KB, far
// below a launch; a prefill chunk of 8192 rows 201 MB (~60 us at 3.35
// TB/s). Up to 8 CTAs an SM, each thread with its row's pieces in flight.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCache = 4;  // pieces a thread keeps in registers

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// V elements of T at p <-> V floats. V = 16 / sizeof(T) (one 16-byte
// piece) or 1.
template <typename T, int V>
struct Piece {
  __device__ __forceinline__ static void load(const T* p, float* f) {
    if constexpr (V == 1) {
      f[0] = static_cast<float>(*p);
    } else {
      Elem<T>::unpack(*reinterpret_cast<const uint4*>(p), f);
    }
  }
  __device__ __forceinline__ static void store(T* p, const float* f) {
    if constexpr (V == 1) {
      if constexpr (sizeof(T) == 2)
        *p = __float2bfloat16_rn(f[0]);
      else
        *p = f[0];
    } else if constexpr (sizeof(T) == 2) {
      uint4 raw;
      unsigned* w = reinterpret_cast<unsigned*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = static_cast<unsigned>(
                   __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]))) |
               (static_cast<unsigned>(__bfloat16_as_ushort(
                    __float2bfloat16_rn(f[2 * i + 1])))
                << 16);
      *reinterpret_cast<uint4*>(p) = raw;
    } else {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
};

// h of piece c of the row (x + res rounded to T, or x), stored to hrow
// when res is given; returns the sum of its squares, added in order.
template <typename T, int V>
__device__ __forceinline__ float make_piece(const T* xrow, const T* rrow,
                                            T* hrow, int c, float* h) {
  Piece<T, V>::load(xrow + static_cast<int64_t>(c) * V, h);
  if (rrow != nullptr) {
    float r[V];
    Piece<T, V>::load(rrow + static_cast<int64_t>(c) * V, r);
#pragma unroll
    for (int e = 0; e < V; ++e) h[e] = round_to<T>(__fadd_rn(h[e], r[e]));
    Piece<T, V>::store(hrow + static_cast<int64_t>(c) * V, h);
  }
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) ss = __fadd_rn(ss, __fmul_rn(h[e], h[e]));
  return ss;
}

template <typename T, int V>
__device__ __forceinline__ void scale_piece(const T* w, T* orow, int c,
                                            const float* h, float r) {
  float wv[V], y[V];
  Piece<T, V>::load(w + static_cast<int64_t>(c) * V, wv);
#pragma unroll
  for (int e = 0; e < V; ++e)
    y[e] = __fmul_rn(round_to<T>(__fmul_rn(h[e], r)), wv[e]);
  Piece<T, V>::store(orow + static_cast<int64_t>(c) * V, y);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const T* __restrict__ w, T* __restrict__ out, T* h_out,
                float* __restrict__ var_out, int rows, int H, float eps) {
  __shared__ float warp_ss[kWarps];
  const int tid = threadIdx.x;
  const int pieces = H / V;
  const float inv_h = __fdiv_rn(1.0f, static_cast<float>(H));
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t off = static_cast<int64_t>(row) * H;
    const T* xrow = x + off;
    const T* rrow = res != nullptr ? res + off : nullptr;
    T* hrow = res != nullptr ? h_out + off : nullptr;
    float cache[kCache][V];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kCache; ++i) {
      const int c = tid + i * kThreads;
      if (c < pieces)
        ss = __fadd_rn(ss, make_piece<T, V>(xrow, rrow, hrow, c, cache[i]));
    }
    for (int c = tid + kCache * kThreads; c < pieces; c += kThreads) {
      float h[V];
      ss = __fadd_rn(ss, make_piece<T, V>(xrow, rrow, hrow, c, h));
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xFFFFFFFFu, ss, m));
    if (tid % 32 == 0) warp_ss[tid / 32] = ss;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total = __fadd_rn(total, warp_ss[i]);
    __syncthreads();  // warp_ss is free for the next row
    const float var = __fmul_rn(total, inv_h);
    const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    if (var_out != nullptr && tid == 0) var_out[row] = var;
    T* orow = out + off;
#pragma unroll
    for (int i = 0; i < kCache; ++i) {
      const int c = tid + i * kThreads;
      if (c < pieces) scale_piece<T, V>(w, orow, c, cache[i], r);
    }
    // Pieces past the cache: h again, from this thread's own stores (plain
    // loads: h_out is written in this launch) or from x.
    const T* src = res != nullptr ? hrow : xrow;
    for (int c = tid + kCache * kThreads; c < pieces; c += kThreads) {
      float h[V];
      Piece<T, V>::load(src + static_cast<int64_t>(c) * V, h);
      scale_piece<T, V>(w, orow, c, h, r);
    }
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* res, const void* w, void* out,
                   void* h, float* var_out, int rows, int H, float eps,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = rows < 8 * sms ? rows : 8 * sms;
  constexpr int kV = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  T* ht = static_cast<T*>(h);
  if (H % kV == 0 && aligned16(x) && aligned16(res) && aligned16(w) &&
      aligned16(out) && aligned16(h))
    rms_norm_kernel<T, kV><<<grid, kThreads, 0, stream>>>(
        xt, rt, wt, ot, ht, var_out, rows, H, eps);
  else
    rms_norm_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        xt, rt, wt, ot, ht, var_out, rows, H, eps);
  return cudaGetLastError();
}

}  // namespace

// x [rows, H] -> out [rows, H], of dtype code ``dtype`` (0 f32, 1 bf16);
// w [H] of that dtype. With res (h and res NULL together, or neither):
// h = x + res is written too and normed. var_out [rows] f32, or NULL: each
// row's mean square, for the checks on the card.
extern "C" int rms_norm_launch(const void* x, const void* res,
                               const void* w, void* out, void* h,
                               float* var_out, int rows, int H, float eps,
                               int dtype, void* stream) {
  if (rows < 1 || H < 1 || (res == nullptr) != (h == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(
        launch<float>(x, res, w, out, h, var_out, rows, H, eps, s));
    case 1: return static_cast<int>(launch<__nv_bfloat16>(
        x, res, w, out, h, var_out, rows, H, eps, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
