// The MLP's SiLU product: out = silu(gate) * up, one launch a layer's
// MLP.
//
// No Pallas counterpart: it replaces the XLA fusion of the JAX model's
// jax.nn.silu(g) * u (quest_tpu/models/llama.py:281), which the port ran
// as two plain PyTorch ops a layer (ops/silu_mul.py:silu_mul_plain:
// F.silu, then the product). It gives those two ops' bits on the card:
//   * silu in f32, x / (1 + expf(-x)), as ATen's CUDA silu computes it
//     for f32 and bf16 (opmath f32), rounded to the input dtype;
//   * then the product of the two input-dtype values in f32, rounded
//     again (ATen's bf16 mul goes through f32 the same way).
// Every step is rounded on its own (__fdiv_rn, __fadd_rn, __fmul_rn, the
// accurate expf; the build takes no --use_fast_math), so nothing
// contracts. Only expf could differ in a bit between this nvcc's
// libdevice and the one torch was built with; chip_smoke.py counts the
// elements that differ and holds them to 1 ulp.
//
// Bound on the H100: bytes, one read of gate and up and one write of out
// (0.70 GB at a T=8192 chunk of Llama-3.1-8B's 14336-wide MLP in bf16,
// ~210 us at 3.35 TB/s; the two plain ops move 1.18 GB). So a
// grid-stride loop of 16-byte vectors, one vector of each operand a
// thread a step; the scalar tail (and unaligned operands) elementwise.
#include "common.cuh"

namespace {

template <typename T>
struct Val;
template <>
struct Val<float> {
  __device__ static float widen(float x) { return x; }
  __device__ static float narrow(float f) { return f; }
};
template <>
struct Val<unsigned short> {      // bf16 bits
  __device__ static float widen(unsigned short x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  __device__ static unsigned short narrow(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};

template <typename T>
__device__ __forceinline__ T silu_mul1(T g, T u) {
  const float x = Val<T>::widen(g);
  const T s = Val<T>::narrow(__fdiv_rn(x, __fadd_rn(1.0f, expf(-x))));
  return Val<T>::narrow(__fmul_rn(Val<T>::widen(s), Val<T>::widen(u)));
}

// The two bf16 of a 32-bit word.
__device__ __forceinline__ unsigned silu_mul2(unsigned g, unsigned u) {
  using B = unsigned short;
  const B lo = silu_mul1<B>(static_cast<B>(g & 0xFFFFu),
                            static_cast<B>(u & 0xFFFFu));
  const B hi = silu_mul1<B>(static_cast<B>(g >> 16), static_cast<B>(u >> 16));
  return static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16);
}

// One 16-byte vector of each operand (4 f32 or 8 bf16).
template <typename T>
__device__ __forceinline__ uint4 silu_mul_vec(uint4 g, uint4 u) {
  if constexpr (sizeof(T) == 4) {
    return make_uint4(
        __float_as_uint(silu_mul1<float>(__uint_as_float(g.x),
                                         __uint_as_float(u.x))),
        __float_as_uint(silu_mul1<float>(__uint_as_float(g.y),
                                         __uint_as_float(u.y))),
        __float_as_uint(silu_mul1<float>(__uint_as_float(g.z),
                                         __uint_as_float(u.z))),
        __float_as_uint(silu_mul1<float>(__uint_as_float(g.w),
                                         __uint_as_float(u.w))));
  } else {
    return make_uint4(silu_mul2(g.x, u.x), silu_mul2(g.y, u.y),
                      silu_mul2(g.z, u.z), silu_mul2(g.w, u.w));
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(256)
silu_mul_kernel(const T* __restrict__ g, const T* __restrict__ u,
                T* __restrict__ out, int64_t n) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  int64_t done = 0;
  if constexpr (VEC) {
    const int64_t nvec = n / kVec;
    const uint4* __restrict__ gv = reinterpret_cast<const uint4*>(g);
    const uint4* __restrict__ uv = reinterpret_cast<const uint4*>(u);
    uint4* __restrict__ ov = reinterpret_cast<uint4*>(out);
    for (int64_t i = tid; i < nvec; i += stride)
      ov[i] = silu_mul_vec<T>(gv[i], uv[i]);
    done = nvec * kVec;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = silu_mul1<T>(g[i], u[i]);
}

template <typename T>
cudaError_t launch(const void* g, const void* u, void* out, int64_t n,
                   cudaStream_t s) {
  constexpr int kThreads = 256, kMaxBlocks = 132 * 16;
  const bool vec = ((reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(u) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t items = vec ? n / (16 / sizeof(T)) + 1 : n;
  const int blocks = static_cast<int>(
      items / kThreads + 1 < kMaxBlocks ? items / kThreads + 1 : kMaxBlocks);
  const T* gt = static_cast<const T*>(g);
  const T* ut = static_cast<const T*>(u);
  T* ot = static_cast<T*>(out);
  if (vec)
    silu_mul_kernel<T, true><<<blocks, kThreads, 0, s>>>(gt, ut, ot, n);
  else
    silu_mul_kernel<T, false><<<blocks, kThreads, 0, s>>>(gt, ut, ot, n);
  return cudaGetLastError();
}

}  // namespace

// gate, up, out: n contiguous elements of dtype_code (0 f32, 1 bf16).
extern "C" int silu_mul_launch(const void* g, const void* u, void* out,
                               long long n, int dtype_code, void* stream) {
  if (n < 1 || g == nullptr || u == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: return static_cast<int>(launch<float>(g, u, out, n, s));
    case 1: return static_cast<int>(launch<unsigned short>(g, u, out, n, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
