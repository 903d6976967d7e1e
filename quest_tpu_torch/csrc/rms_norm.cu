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
// x, res, out, h [rows, H] and w [H], of one dtype T (bf16 or f32).
//
// Bound on the H100: bytes. x (and res) read once, out (and h) written
// once, w read once: a decode step's 2 rows of 4096 bf16 move 34 KB, far
// below a launch; a prefill chunk of 8192 rows 268 MB (~80 us at 3.35
// TB/s). At decode the time is latency: what counts is how many memory
// round trips a row waits on in turn, and whether they reach DRAM. So a
// CTA of 256 threads, one row at a time (a grid-stride loop over rows, up
// to 8 CTAs an SM):
//   * its first P pieces of w (16 bytes each, P = 1, 2 or 4, the least
//     that holds a row's pieces a thread at H = 4096) are loaded once,
//     before the row loop, and kept as raw bits until the scale needs
//     them, so nothing waits on them before the row's own loads;
//   * a row's P pieces of x and res are all loaded before any store and
//     before the reduction (every pointer __restrict__), so the row waits
//     on one round trip, not one a piece; h stays in registers as T's
//     bits (8 registers a bf16 piece), which keeps the prefill's
//     occupancy;
//   * the sum of squares takes one barrier a row: a butterfly in each
//     warp, the warps' sums into one half of a double buffer in shared
//     memory, __syncthreads, every thread adding the 8 sums in order (the
//     next row writes the other half, and that row's barrier orders the
//     row after it). A thread's pieces in order, then the butterfly, then
//     the warps in order: every call sums in the same order;
//   * the scale reads h and w from registers. Wider rows keep a loop past
//     the P pieces (h re-read from this thread's own stores, or x). Rows
//     whose width or pointers are not 16-byte aligned take the same code
//     an element at a time.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// V elements of T at p: raw bits <-> V floats. V = 16 / sizeof(T) (one
// 16-byte piece) or 1.
template <typename T, int V>
struct Piece {
  using Raw = std::conditional_t<V == 1, T, uint4>;
  __device__ __forceinline__ static Raw load(const T* p) {
    if constexpr (V == 1)
      return *p;
    else
      return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void unpack(const Raw& raw, float* f) {
    if constexpr (V == 1)
      f[0] = static_cast<float>(raw);
    else
      Elem<T>::unpack(raw, f);
  }
  // f, whose values T holds exactly or which T rounds to nearest even.
  __device__ __forceinline__ static Raw pack(const float* f) {
    if constexpr (V == 1) {
      if constexpr (sizeof(T) == 2)
        return __float2bfloat16_rn(f[0]);
      else
        return f[0];
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
      return raw;
    } else {
      return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                        __float_as_uint(f[2]), __float_as_uint(f[3]));
    }
  }
  __device__ __forceinline__ static void store(T* p, const Raw& raw) {
    if constexpr (V == 1)
      *p = raw;
    else
      *reinterpret_cast<uint4*>(p) = raw;
  }
};

// The piece's h from its raw x (and, with RES, res) bits, left in xr as
// T's bits (T holds h exactly) and stored to hp with RES; returns the sum
// of its squares, added in order.
template <typename T, int V, bool RES>
__device__ __forceinline__ float make_h(typename Piece<T, V>::Raw& xr,
                                        const typename Piece<T, V>::Raw& rr,
                                        T* hp) {
  float h[V];
  Piece<T, V>::unpack(xr, h);
  if constexpr (RES) {
    float r[V];
    Piece<T, V>::unpack(rr, r);
#pragma unroll
    for (int e = 0; e < V; ++e) h[e] = round_to<T>(__fadd_rn(h[e], r[e]));
    xr = Piece<T, V>::pack(h);
    Piece<T, V>::store(hp, xr);
  }
  float ss = 0.f;
#pragma unroll
  for (int e = 0; e < V; ++e) ss = __fadd_rn(ss, __fmul_rn(h[e], h[e]));
  return ss;
}

template <typename T, int V>
__device__ __forceinline__ void scale_piece(
    const typename Piece<T, V>::Raw& hr, const typename Piece<T, V>::Raw& wr,
    T* op, float r) {
  float h[V], wv[V], y[V];
  Piece<T, V>::unpack(hr, h);
  Piece<T, V>::unpack(wr, wv);
#pragma unroll
  for (int e = 0; e < V; ++e)
    y[e] = __fmul_rn(round_to<T>(__fmul_rn(h[e], r)), wv[e]);
  Piece<T, V>::store(op, Piece<T, V>::pack(y));
}

template <typename T, int V, int P, bool RES>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                const T* __restrict__ w, T* __restrict__ out,
                T* __restrict__ h_out, float* __restrict__ var_out, int rows,
                int H, float eps) {
  using Raw = typename Piece<T, V>::Raw;
  __shared__ float warp_ss[2][kWarps];
  const int tid = threadIdx.x;
  const int pieces = H / V;
  const float inv_h = __fdiv_rn(1.0f, static_cast<float>(H));
  Raw wr[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int c = tid + i * kThreads;
    if (c < pieces) wr[i] = Piece<T, V>::load(w + c * V);
  }
  int buf = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, buf ^= 1) {
    const int64_t off = static_cast<int64_t>(row) * H;
    const T* xrow = x + off;
    const T* rrow = RES ? res + off : nullptr;
    T* hrow = RES ? h_out + off : nullptr;
    T* orow = out + off;
    // Every load of the row's first P pieces before any store; x's bits
    // become h's.
    Raw hr[P], rr[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = tid + i * kThreads;
      if (c < pieces) {
        hr[i] = Piece<T, V>::load(xrow + c * V);
        if constexpr (RES) rr[i] = Piece<T, V>::load(rrow + c * V);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = tid + i * kThreads;
      if (c < pieces)
        ss = __fadd_rn(ss, make_h<T, V, RES>(hr[i], rr[i], hrow + c * V));
    }
    for (int c = tid + P * kThreads; c < pieces; c += kThreads) {
      Raw a = Piece<T, V>::load(xrow + c * V), b = a;
      if constexpr (RES) b = Piece<T, V>::load(rrow + c * V);
      ss = __fadd_rn(ss, make_h<T, V, RES>(a, b, hrow + c * V));
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xFFFFFFFFu, ss, m));
    if (tid % 32 == 0) warp_ss[buf][tid / 32] = ss;
    __syncthreads();
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total = __fadd_rn(total, warp_ss[buf][i]);
    const float var = __fmul_rn(total, inv_h);
    const float r = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
    if (var_out != nullptr && tid == 0) var_out[row] = var;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = tid + i * kThreads;
      if (c < pieces) scale_piece<T, V>(hr[i], wr[i], orow + c * V, r);
    }
    // Pieces past the P in registers: h again, from this thread's own
    // stores (h_out is written in this launch) or from x.
    const T* src = RES ? hrow : xrow;
    for (int c = tid + P * kThreads; c < pieces; c += kThreads)
      scale_piece<T, V>(Piece<T, V>::load(src + c * V),
                        Piece<T, V>::load(w + c * V), orow + c * V, r);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int V, int P, bool RES>
cudaError_t launch_k(int grid, const T* x, const T* res, const T* w, T* out,
                     T* h, float* var_out, int rows, int H, float eps,
                     cudaStream_t stream) {
  rms_norm_kernel<T, V, P, RES><<<grid, kThreads, 0, stream>>>(
      x, res, w, out, h, var_out, rows, H, eps);
  return cudaGetLastError();
}

template <typename T, int V, bool RES>
cudaError_t launch_v(int grid, const T* x, const T* res, const T* w, T* out,
                     T* h, float* var_out, int rows, int H, float eps,
                     cudaStream_t stream) {
  const int per_thread = (H / V + kThreads - 1) / kThreads;
  if (per_thread <= 1)
    return launch_k<T, V, 1, RES>(grid, x, res, w, out, h, var_out, rows, H,
                                  eps, stream);
  if (per_thread <= 2)
    return launch_k<T, V, 2, RES>(grid, x, res, w, out, h, var_out, rows, H,
                                  eps, stream);
  return launch_k<T, V, 4, RES>(grid, x, res, w, out, h, var_out, rows, H,
                                eps, stream);
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
  const bool vec = H % kV == 0 && aligned16(x) && aligned16(res) &&
                   aligned16(w) && aligned16(out) && aligned16(h);
  if (res != nullptr)
    return vec ? launch_v<T, kV, true>(grid, xt, rt, wt, ot, ht, var_out,
                                       rows, H, eps, stream)
               : launch_v<T, 1, true>(grid, xt, rt, wt, ot, ht, var_out,
                                      rows, H, eps, stream);
  return vec ? launch_v<T, kV, false>(grid, xt, rt, wt, ot, ht, var_out,
                                      rows, H, eps, stream)
             : launch_v<T, 1, false>(grid, xt, rt, wt, ot, ht, var_out, rows,
                                     H, eps, stream);
}

}  // namespace

// x [rows, H] -> out [rows, H], of dtype code ``dtype`` (0 f32, 1 bf16);
// w [H] of that dtype. With res (h and res NULL together, or neither):
// h = x + res is written too and normed. var_out [rows] f32, or NULL: each
// row's mean square, for the checks on the card. No output may overlap an
// input.
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
