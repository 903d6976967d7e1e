// Helpers shared by the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define QT_MASK_VALUE (-1e30f)  // finite, as MASK_VALUE in ops/utils.py

// Every library exports this so the ctypes wrapper can name a CUDA error.
extern "C" const char* qt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Element traits: 16 bytes of a row hold kPerChunk elements; ``round``
// rounds to the dtype q and p take before the products with such rows.
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

// fp8 e4m3 as the JAX kernels read it (quest_tpu/ops/pallas_utils.py:
// upcast_fp8, ops/utils.py:upcast_fp8 here): the bf16 bits of code u are
// sign * 256 + (em < 8 ? 0 : em * 16 + (120 << 7)), em the exponent and
// mantissa bits. Denormals flush to zero and the NaN codes read as 480;
// the hardware cvt keeps denormals, so it is not used.
__device__ __forceinline__ unsigned fp8_e4m3_bf16_bits(unsigned u) {
  const unsigned em = u & 0x7Fu;
  return ((u & 0x80u) << 8) | (em < 8u ? 0u : (em << 4) + (120u << 7));
}

__device__ __forceinline__ float fp8_e4m3_to_float(unsigned u) {
  return __uint_as_float(fp8_e4m3_bf16_bits(u) << 16);
}

// fp8 e4m3 pools and metadata. ``round`` goes to bf16, not fp8: the JAX
// kernels keep q and p at bf16 over an fp8 pool (the upcast pages are
// bf16, and p is cast to their dtype). Kernels that keep tiles in shared
// memory widen fp8 to bf16 as they store it (TileElem below).
template <>
struct Elem<__nv_fp8_e4m3> {
  static constexpr int kPerChunk = 16;
  __device__ __forceinline__ static float round(float x) {
    return Elem<__nv_bfloat16>::round(x);
  }
  __device__ __forceinline__ static void unpack(const uint4& raw, float* f) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * i + j] = fp8_e4m3_to_float((w[i] >> (8 * j)) & 0xFFu);
    }
  }
};

// Four fp8 e4m3 values (one word) as four bf16 values by the recipe above,
// all four lanes at once: lo holds elements 0, 1, hi elements 2, 3.
// Bitwise equal to fp8_e4m3_bf16_bits on every code: a byte's em is kept
// where em + 0x78 carries into bit 7 (em >= 8); each kept lane gets the
// bias 120 << 7 = 0x3C00 and every lane its sign at bit 15.
__device__ __forceinline__ void fp8x4_to_bf16(unsigned w, unsigned& lo,
                                              unsigned& hi) {
  unsigned em = w & 0x7F7F7F7Fu;
  const unsigned keep = ((em + 0x78787878u) & 0x80808080u) >> 7;
  const unsigned mask = keep * 0xFFu;                 // 0xFF per kept byte
  em &= mask;
  const unsigned sb = (w & 0x80808080u) | (mask & 0x3C3C3C3Cu);
  // __byte_perm(x, 0, s): bytes of x (0-3) or zeros (4) into a word.
  lo = (__byte_perm(em, 0, 0x4140) << 4) + __byte_perm(sb, 0, 0x1404);
  hi = (__byte_perm(em, 0, 0x4342) << 4) + __byte_perm(sb, 0, 0x3424);
}

// 16 fp8 e4m3 values (one 16-byte chunk) as 16 bf16 values by the recipe
// above: lo holds elements 0..7, hi elements 8..15.
__device__ __forceinline__ void fp8x16_to_bf16(const uint4& raw, uint4& lo,
                                               uint4& hi) {
  fp8x4_to_bf16(raw.x, lo.x, lo.y);
  fp8x4_to_bf16(raw.y, lo.z, lo.w);
  fp8x4_to_bf16(raw.z, hi.x, hi.y);
  fp8x4_to_bf16(raw.w, hi.z, hi.w);
}

// The element type a kernel keeps a pool's tiles in, in shared memory:
// the pool's own, bf16 for fp8 (each tile is widened as it arrives, so
// the products read bf16 and the recipe runs once an element).
template <typename T>
struct TileElem {
  using type = T;
};
template <>
struct TileElem<__nv_fp8_e4m3> {
  using type = __nv_bfloat16;
};

// Stores one 16-byte chunk of pool elements T at dst, a tile of
// TileElem<T>::type: as it is, or widened to 32 bytes of bf16.
template <typename T>
__device__ __forceinline__ void store_tile_chunk(
    typename TileElem<T>::type* dst, const uint4& raw) {
  if constexpr (sizeof(T) == 1) {
    uint4 lo, hi;
    fp8x16_to_bf16(raw, lo, hi);
    reinterpret_cast<uint4*>(dst)[0] = lo;
    reinterpret_cast<uint4*>(dst)[1] = hi;
  } else {
    *reinterpret_cast<uint4*>(dst) = raw;
  }
}

// Calls f(T{}) for the element type of a dtype code (ops/utils.py
// DTYPE_CODES: 0 f32, 1 bf16, 2 fp8 e4m3).
template <typename F>
cudaError_t with_elem(int code, F&& f) {
  switch (code) {
    case 0: return f(float{});
    case 1: return f(__nv_bfloat16{});
    case 2: return f(__nv_fp8_e4m3{});
    default: return cudaErrorInvalidValue;
  }
}

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

// Shared-memory mbarriers (sm_90).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of the given parity; traps (an error the host
// sees, not a hang) if it has not completed after ~10 s.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// Makes a thread's mbarrier inits visible to the async proxy (bulk copies)
// and to the cluster.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this CTA's generic-proxy accesses of shared memory before later
// bulk copies into it (a slot that was read is refilled).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One bulk async copy of ``bytes`` (a multiple of 16, both addresses
// 16-byte aligned) from global to this CTA's shared memory, completing on
// ``bar`` (which must expect the bytes).
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes from global to shared memory (cp.async, L2 only); with ``ok``
// false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
