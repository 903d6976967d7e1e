// Helpers shared by the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define QT_MASK_VALUE (-1e30f)  // finite, as MASK_VALUE in ops/utils.py

// Every library exports this so the ctypes wrapper can name a CUDA error.
extern "C" const char* qt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Element traits: 16 bytes of a row hold kPerChunk elements.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerChunk = 8;
  __device__ __forceinline__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // Round to the storage type and back (round to nearest even), as
  // JAX's ``p.astype(v.dtype)`` before the PV product.
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ __forceinline__ static void unpack(const uint4& raw, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <>
struct Elem<float> {
  static constexpr int kPerChunk = 4;
  __device__ __forceinline__ static float to_float(float x) { return x; }
  __device__ __forceinline__ static float round(float x) { return x; }
  __device__ __forceinline__ static void unpack(const uint4& raw, float* f) {
    const float* p = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = p[i];
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Element offset of token ``e`` of physical page ``phys`` (K row; the V
// row is ``page * D`` further) in one layer of the pool
// [Hkv, NP, 2, page, D].
__device__ __forceinline__ int64_t kv_row(int h_kv, int phys, int e, int NP,
                                          int page, int D) {
  return ((static_cast<int64_t>(h_kv) * NP + phys) * 2 * page + e) * D;
}

// Physical page of logical page ``lp`` of batch row ``b``.
__device__ __forceinline__ int phys_page(const int* tab, int b, int NB,
                                         int bpp, int lp) {
  return tab[b * NB + lp / bpp] * bpp + lp % bpp;
}
