// Rotary position embedding of q and k together, one launch a layer.
//
// No Pallas counterpart: it replaces the XLA fusion that the JAX package
// compiles quest_tpu/ops/rope.py:85 apply_rope into (jitted), which the
// port ran as 9 plain PyTorch ops a tensor (ops/rope.py:rotate_plain:
// .float(), four products, a difference, a sum, cat, the cast back). It
// gives the plain version's bits: with x1 = x[..., :64], x2 = x[..., 64:],
// out[..., :64] = x1*cos - x2*sin and out[..., 64:] = x2*cos + x1*sin, each
// product and each sum rounded to f32 on its own (__fmul_rn, __fsub_rn,
// __fadd_rn: never contracted into an FMA, as the plain version's separate
// kernels are not), then rounded once to x's dtype (bf16: round to nearest
// even). cos / sin [tokens, 64] f32 serve every head of a token.
//
// Bound on the H100: bytes. q and k are read and written once, cos and sin
// read once (a prefill chunk of 8192 tokens at 32 / 8 heads moves 168 MB,
// ~50 us at 3.35 TB/s; a decode step's 40 rows of a token ~20 KB, far below
// a launch). So each thread takes 8 rotation pairs of one head row: two
// 16-byte loads of x (bf16; four for f32), four of cos / sin, which the 8
// threads of a row and the rows of a token share through L1; a grid-stride
// loop keeps 16 CTAs an SM in flight over long chunks.
#include "common.cuh"

namespace {

constexpr int kD = 128;
constexpr int kHalf = kD / 2;
constexpr int kPairs = 8;                      // pairs a thread
constexpr int kUnitsPerRow = kHalf / kPairs;   // 8 threads a head row
constexpr int kThreads = 256;

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    Elem<__nv_bfloat16>::unpack(*reinterpret_cast<const uint4*>(p), f);
  }
  __device__ static void store(__nv_bfloat16* p, const float* f) {
    uint4 raw;
    unsigned* w = reinterpret_cast<unsigned*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = static_cast<unsigned>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i]))) |
             (static_cast<unsigned>(
                  __bfloat16_as_ushort(__float2bfloat16_rn(f[2 * i + 1])))
              << 16);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec<float> {
  __device__ static void load(const float* p, float* f) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
  __device__ static void store(float* p, const float* f) {
    reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
            T* __restrict__ qo, T* __restrict__ ko,
            const float* __restrict__ cosv, const float* __restrict__ sinv,
            int64_t rows_q, int64_t rows, int Hq, int Hkv) {
  const int64_t units = rows * kUnitsPerRow;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       u < units; u += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t r = u / kUnitsPerRow;
    const int j = static_cast<int>(u % kUnitsPerRow) * kPairs;
    const bool is_q = r < rows_q;
    const int64_t rr = is_q ? r : r - rows_q;
    const int64_t tok = rr / (is_q ? Hq : Hkv);
    const T* x = (is_q ? q : k) + rr * kD;
    T* o = (is_q ? qo : ko) + rr * kD;
    float x1[kPairs], x2[kPairs], c[kPairs], s[kPairs];
    Vec<T>::load(x + j, x1);
    Vec<T>::load(x + kHalf + j, x2);
    Vec<float>::load(cosv + tok * kHalf + j, c);
    Vec<float>::load(sinv + tok * kHalf + j, s);
    float lo[kPairs], hi[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      lo[i] = __fsub_rn(__fmul_rn(x1[i], c[i]), __fmul_rn(x2[i], s[i]));
      hi[i] = __fadd_rn(__fmul_rn(x2[i], c[i]), __fmul_rn(x1[i], s[i]));
    }
    Vec<T>::store(o + j, lo);
    Vec<T>::store(o + kHalf + j, hi);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, void* qo, void* ko,
                   const float* cosv, const float* sinv, int tokens, int Hq,
                   int Hkv, cudaStream_t stream) {
  const int64_t rows_q = static_cast<int64_t>(tokens) * Hq;
  const int64_t rows = rows_q + static_cast<int64_t>(tokens) * Hkv;
  const int64_t blocks = (rows * kUnitsPerRow + kThreads - 1) / kThreads;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(
      blocks < 16ll * sms ? blocks : 16ll * sms);
  rope_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<T*>(qo),
      static_cast<T*>(ko), cosv, sinv, rows_q, rows, Hq, Hkv);
  return cudaGetLastError();
}

}  // namespace

// q [tokens, Hq, 128] -> qo, k [tokens, Hkv, 128] -> ko (k, ko NULL and
// Hkv 0 for q alone), both of dtype code ``dtype`` (0 f32, 1 bf16);
// cos / sin [tokens, 64] f32. Every pointer 16-byte aligned.
extern "C" int rope_launch(const void* q, const void* k, void* qo, void* ko,
                           const float* cosv, const float* sinv, int tokens,
                           int Hq, int Hkv, int dtype, void* stream) {
  if (tokens < 1 || Hq < 1 || Hkv < 0 || (Hkv > 0 && (k == nullptr ||
                                                      ko == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(
        launch<float>(q, k, qo, ko, cosv, sinv, tokens, Hq, Hkv, s));
    case 1: return static_cast<int>(
        launch<__nv_bfloat16>(q, k, qo, ko, cosv, sinv, tokens, Hq, Hkv, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
