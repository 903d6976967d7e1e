// The decode step's KV append: one token a batch row written into the
// paged pool and folded into its page's min/max Key metadata, one launch a
// layer.
//
// No Pallas counterpart: it replaces the XLA fusion that the JAX package
// compiles quest_tpu/kv/paged_kv.py:354 append_decode_at into (a chain of
// dynamic_update_slices with the metadata fold), which the port ran as
// ~44 plain PyTorch ops a layer (kv/paged_kv.py:append_decode_at_plain).
// It computes exactly what that plain version computes, bit for bit:
//   * per row b, from device memory (a replayed graph sees each step's
//     values): pos = seq_lens[b], p_log = pos / page, e = pos % page;
//     blk = tab[b, min(p_log / bpp, NB - 1)] (block 0, scratch, for an
//     inactive row); off = p_log % bpp (not clamped); p_phys = blk * bpp
//     + off;
//   * kv[h, p_phys, K|V, e, :] = cast(finite(k|v)) for every KV head,
//     finite() zeroing inf and NaN lanes before the cast;
//   * k_max / k_min[h, blk, off, :] = fold of the POOL-ROUNDED key in f32:
//     the key itself at a page's first token (e == 0), else max / min with
//     the old value, as torch.maximum / torch.minimum (NaN propagates);
//     an inactive row leaves its metadata as it is (the plain version
//     writes back what it read: the same bits).
// Casts are torch's: f32 -> bf16 round to nearest even; e4m3 both ways by
// c10's software routines (Float8_e4m3fn.h), which keep denormals. The
// one place torch versions differ, the code of a finite value that
// rounds past 448, comes from the wrapper (ops/utils.py:fp8_cast_codes
// asks the card's torch once).
//
// Bound on the H100: bytes, and far below a launch: 2 x B x Hkv x 128
// elements in, as many into the pool, 2 x B x Hkv x 128 metadata elements
// read and written (16 KB at B=1, 8 KV heads, bf16). So the design is the
// least latency: one warp a (KV head, row), 4 dims a lane, the row's
// index math in registers, no shared memory and no second pass. Rows never
// share a written slot outside scratch (a shared prefix block is only
// read by the rows that share it), so CTAs need no ordering.
#include "common.cuh"

namespace {

constexpr int kD = 128;
constexpr int kPerLane = kD / 32;

// e4m3 codes that torch versions disagree on, for a finite value: ``ovf``
// for |x| >= 480, ``carry`` for a rounding that carries into 0x7F
// ((464, 480)). Older torch gives NaN (0x7F), newer saturates (0x7E).
struct Fp8Codes {
  unsigned ovf, carry;
};

// c10's fp8e4m3fn_from_fp32_value, with the two codes above.
__device__ __forceinline__ unsigned fp8_from_f32(float f, Fp8Codes c) {
  const unsigned fp8_max = 1087u << 20;        // 480.0f
  const unsigned denorm_mask = 141u << 23;
  unsigned bits = __float_as_uint(f);
  const unsigned sign = bits & 0x80000000u;
  bits ^= sign;
  unsigned r;
  if (bits >= fp8_max) {
    r = bits > 0x7F800000u ? 0x7Fu : c.ovf;
  } else if (bits < (121u << 23)) {            // below 2^-6: denormal
    bits = __float_as_uint(__fadd_rn(__uint_as_float(bits),
                                     __uint_as_float(denorm_mask)));
    r = (bits - denorm_mask) & 0xFFu;
  } else {
    const unsigned mant_odd = (bits >> 20) & 1u;
    bits += (static_cast<unsigned>(7 - 127) << 23) + 0x7FFFFu;
    bits += mant_odd;
    r = (bits >> 20) & 0xFFu;
    if (r == 0x7Fu) r = c.carry;
  }
  return r | (sign >> 24);
}

// c10's fp8e4m3fn_to_fp32_value: denormals kept, 0x7F / 0xFF to NaN.
__device__ __forceinline__ float fp8_to_f32(unsigned u) {
  const unsigned w = u << 24;
  const unsigned sign = w & 0x80000000u;
  const unsigned nonsign = w & 0x7FFFFFFFu;
  unsigned renorm = __clz(nonsign);
  renorm = renorm > 4 ? renorm - 4 : 0;
  const int inf_nan = (static_cast<int>(nonsign + 0x01000000u) >> 8) &
                      0x7F800000;
  const int zero = static_cast<int>(nonsign - 1) >> 31;
  return __uint_as_float(
      sign | ((((nonsign << renorm >> 4) + ((0x78u - renorm) << 23)) |
               static_cast<unsigned>(inf_nan)) &
              ~static_cast<unsigned>(zero)));
}

// Storage of a dtype code (ops/utils.py DTYPE_CODES): the bits, widened
// to f32 and narrowed from it as torch's casts do.
template <int C>
struct Store;
template <>
struct Store<0> {
  using T = float;
  __device__ static float widen(T x) { return x; }
  __device__ static T narrow(float f, Fp8Codes) { return f; }
};
template <>
struct Store<1> {
  using T = unsigned short;
  __device__ static float widen(T x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  __device__ static T narrow(float f, Fp8Codes) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};
template <>
struct Store<2> {
  using T = unsigned char;
  __device__ static float widen(T x) { return fp8_to_f32(x); }
  __device__ static T narrow(float f, Fp8Codes c) {
    return static_cast<T>(fp8_from_f32(f, c));
  }
};

// torch.maximum / torch.minimum on the card: a NaN operand wins, the
// first one first.
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}

template <int IN, int POOL, int META>
__global__ void __launch_bounds__(32)
append_decode_kernel(typename Store<POOL>::T* __restrict__ kv,
                     typename Store<META>::T* __restrict__ kmax,
                     typename Store<META>::T* __restrict__ kmin,
                     const int* __restrict__ tab,
                     const int* __restrict__ seq_lens,
                     const unsigned char* __restrict__ active,
                     const typename Store<IN>::T* __restrict__ k,
                     const typename Store<IN>::T* __restrict__ v, int NP,
                     int page, int NPB, int bpp, int NB, Fp8Codes pool_c,
                     Fp8Codes meta_c) {
  using In = Store<IN>;
  using Pool = Store<POOL>;
  using Meta = Store<META>;
  const int h = blockIdx.x, b = blockIdx.y, Hkv = gridDim.x;
  const int pos = seq_lens[b];
  const bool act = active == nullptr || active[b] != 0;
  const int p_log = pos / page, e = pos % page;
  const int blk = act ? tab[b * NB + min(p_log / bpp, NB - 1)] : 0;
  const int off = p_log % bpp;
  const int64_t src = (static_cast<int64_t>(b) * Hkv + h) * kD;
  const int64_t dst = kv_row(h, blk * bpp + off, e, NP, page, kD);
  const int64_t meta = ((static_cast<int64_t>(h) * NPB + blk) * bpp + off) *
                       kD;
  const int d0 = threadIdx.x * kPerLane;
  typename Pool::T kq[kPerLane], vq[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const float kf = In::widen(k[src + d0 + i]);   // exact
    const float vf = In::widen(v[src + d0 + i]);
    kq[i] = Pool::narrow(isfinite(kf) ? kf : 0.f, pool_c);
    vq[i] = Pool::narrow(isfinite(vf) ? vf : 0.f, pool_c);
    kv[dst + d0 + i] = kq[i];
    kv[dst + static_cast<int64_t>(page) * kD + d0 + i] = vq[i];
  }
  if (!act) return;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const float kf = Pool::widen(kq[i]);
    float hi = kf, lo = kf;
    if (e != 0) {
      hi = nan_max(Meta::widen(kmax[meta + d0 + i]), kf);
      lo = nan_min(Meta::widen(kmin[meta + d0 + i]), kf);
    }
    kmax[meta + d0 + i] = Meta::narrow(hi, meta_c);
    kmin[meta + d0 + i] = Meta::narrow(lo, meta_c);
  }
}

template <int IN, int POOL, int META>
cudaError_t launch(void* kv, void* kmax, void* kmin, const int* tab,
                   const int* seq_lens, const unsigned char* active,
                   const void* k, const void* v, int B, int Hkv, int NP,
                   int page, int NPB, int bpp, int NB, Fp8Codes pool_c,
                   Fp8Codes meta_c, cudaStream_t stream) {
  append_decode_kernel<IN, POOL, META><<<dim3(Hkv, B), 32, 0, stream>>>(
      static_cast<typename Store<POOL>::T*>(kv),
      static_cast<typename Store<META>::T*>(kmax),
      static_cast<typename Store<META>::T*>(kmin), tab, seq_lens, active,
      static_cast<const typename Store<IN>::T*>(k),
      static_cast<const typename Store<IN>::T*>(v), NP, page, NPB, bpp, NB,
      pool_c, meta_c);
  return cudaGetLastError();
}

template <int IN, int POOL>
cudaError_t with_meta(int meta_code, void* kv, void* kmax, void* kmin,
                      const int* tab, const int* seq_lens,
                      const unsigned char* active, const void* k,
                      const void* v, int B, int Hkv, int NP, int page,
                      int NPB, int bpp, int NB, Fp8Codes pool_c,
                      Fp8Codes meta_c, cudaStream_t s) {
  switch (meta_code) {
    case 0: return launch<IN, POOL, 0>(kv, kmax, kmin, tab, seq_lens, active,
                                       k, v, B, Hkv, NP, page, NPB, bpp, NB,
                                       pool_c, meta_c, s);
    case 1: return launch<IN, POOL, 1>(kv, kmax, kmin, tab, seq_lens, active,
                                       k, v, B, Hkv, NP, page, NPB, bpp, NB,
                                       pool_c, meta_c, s);
    case 2: return launch<IN, POOL, 2>(kv, kmax, kmin, tab, seq_lens, active,
                                       k, v, B, Hkv, NP, page, NPB, bpp, NB,
                                       pool_c, meta_c, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int IN>
cudaError_t with_pool(int kv_code, int meta_code, void* kv, void* kmax,
                      void* kmin, const int* tab, const int* seq_lens,
                      const unsigned char* active, const void* k,
                      const void* v, int B, int Hkv, int NP, int page,
                      int NPB, int bpp, int NB, Fp8Codes pool_c,
                      Fp8Codes meta_c, cudaStream_t s) {
  switch (kv_code) {
    case 0: return with_meta<IN, 0>(meta_code, kv, kmax, kmin, tab, seq_lens,
                                    active, k, v, B, Hkv, NP, page, NPB, bpp,
                                    NB, pool_c, meta_c, s);
    case 1: return with_meta<IN, 1>(meta_code, kv, kmax, kmin, tab, seq_lens,
                                    active, k, v, B, Hkv, NP, page, NPB, bpp,
                                    NB, pool_c, meta_c, s);
    case 2: return with_meta<IN, 2>(meta_code, kv, kmax, kmin, tab, seq_lens,
                                    active, k, v, B, Hkv, NP, page, NPB, bpp,
                                    NB, pool_c, meta_c, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One layer: kv [Hkv, NP, 2, page, 128] (pool dtype kv_code), kmax / kmin
// [Hkv, NPB, bpp, 128] (meta_code), tab [B, NB] int32, seq_lens [B] int32,
// active [B] bool or NULL (every row active), k / v [B, Hkv, 128] (in_code:
// 0 f32, 1 bf16). pool_* / meta_*: the e4m3 codes of a finite overflow
// and of a rounding carry into 0x7F, for the casts into the pool (from
// the input dtype) and into the metadata (from f32).
extern "C" int append_decode_launch(void* kv, void* kmax, void* kmin,
                                    const int* tab, const int* seq_lens,
                                    const unsigned char* active,
                                    const void* k, const void* v, int B,
                                    int Hkv, int NP, int page, int NPB,
                                    int bpp, int NB, int in_code, int kv_code,
                                    int meta_code, int pool_ovf,
                                    int pool_carry, int meta_ovf,
                                    int meta_carry, void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || page < 1 || bpp < 1 || NB < 1 ||
      NPB < 1 || NP != NPB * bpp)
    return static_cast<int>(cudaErrorInvalidValue);
  const Fp8Codes pool_c{static_cast<unsigned>(pool_ovf),
                        static_cast<unsigned>(pool_carry)};
  const Fp8Codes meta_c{static_cast<unsigned>(meta_ovf),
                        static_cast<unsigned>(meta_carry)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case 0: return static_cast<int>(with_pool<0>(
        kv_code, meta_code, kv, kmax, kmin, tab, seq_lens, active, k, v, B,
        Hkv, NP, page, NPB, bpp, NB, pool_c, meta_c, s));
    case 1: return static_cast<int>(with_pool<1>(
        kv_code, meta_code, kv, kmax, kmin, tab, seq_lens, active, k, v, B,
        Hkv, NP, page, NPB, bpp, NB, pool_c, meta_c, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
