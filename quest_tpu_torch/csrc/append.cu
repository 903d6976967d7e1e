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
// With the rotate flag (rope_append_launch, the decode step's path) the
// same launch also does the decode rope, which the port ran before as a
// second launch (csrc/rope.cu): it writes q_out = rotate_plain(q) and
// appends rotate_plain(k) in place of k, bit for bit the plain chain
// append_decode_at_plain(rotate_plain(k), v): the rotation of rope.cu
// (each product and sum rounded to f32 on its own, __fmul_rn / __fsub_rn /
// __fadd_rn), rounded to the input dtype FIRST and only then cast into the
// pool, as the plain chain rounds twice (an f32 rotation cast straight to
// e4m3 would give other codes). It replaces XLA's fusions of
// quest_tpu/kv/paged_kv.py:354 and of the jitted quest_tpu/ops/rope.py:85
// apply_rope at decode.
//
// Bound on the H100: bytes, and far below a launch: 2 x B x Hkv x 128
// elements in, as many into the pool, 2 x B x Hkv x 128 metadata elements
// read and written (16 KB at B=1, 8 KV heads, bf16); with the rope also
// q read and written and a row's cos / sin. So the design is the least
// latency, in dependent memory round trips: a CTA a (KV head, row), no
// shared memory, no barrier and no second pass. Warp 0 appends the head's
// k and v, each lane owning the two rotation pairs (2l + j, 64 + 2l + j),
// so k rotates in registers. Its loads of seq_lens, the mask, k, v, cos
// and sin go out together; the chain seq_lens -> table entry -> old
// metadata is all it waits on in turn, and every store comes after it.
// Under the flag, warps 1.. (at most 31) rotate the group's G query heads,
// one head row a warp, at the cost of one round trip that overlaps the
// append's chain. Rows never share a written slot outside scratch (a
// shared prefix block is only read by the rows that share it), so CTAs
// need no ordering.
//
// The prefill route (append_prefill_launch) writes a chunk of T tokens a
// row and recomputes the min/max metadata of the window it touches, one
// launch a layer's chunk. No Pallas counterpart either: it replaces the
// XLA fusion of quest_tpu/kv/paged_kv.py:446 append_prefill_at (Quest's
// own reference runs it as one CUDA kernel, AppendPagedKVCachePrefill),
// which the port ran as ~70 plain PyTorch ops a layer
// (kv/paged_kv.py:append_prefill_at_plain). Bit for bit that plain
// version outside scratch block 0:
//   * per row b, read on the device: offset = seq_lens[b], n = new_lens[b]
//     (T without new_lens); W = min(P, T / page + 2) pages from p0 =
//     min(offset / page, P - W); the write starts at p0 * page + local,
//     local = clamp(offset - p0 * page, 0, W * page - T) (the clamp of
//     JAX's dynamic_update_slice, which bites at the pool's end);
//   * token t goes to logical position start + t as cast(finite(k|v)),
//     every KV head, padding tokens t >= n included;
//   * each window page's metadata is the fold over its slots of the
//     POOL-ROUNDED key in f32 (the new token's where the slot was written,
//     else the pool's old key), a slot valid when its position is below
//     offset + n; invalid slots fold as -3.0e38 into the max and +3.0e38
//     into the min, as the plain version's where() does (so a valid key
//     below -3.0e38 loses to an invalid slot's -3.0e38 there too); NaN
//     propagates as in torch.amax / amin (an fp8 pool holds NaN codes;
//     which of two NaNs of different signs wins is the reduction order's,
//     in the plain version too); written, cast to the metadata dtype,
//     only for pages with a valid slot. An fp8 pool key widens by c10's
//     cast (denormals kept), not upcast_fp8.
//   * A row with n == 0 writes nothing at all (the plain version sends it
//     to scratch block 0, which no row reads as its own; with several
//     such rows its scratch bits are not determined there either).
// Bound on the H100: bytes. At the B=1, T=8192 chunk of 8 KV heads k and
// v in bf16 are 33.5 MB read, the pool rows 33.5 MB written, and about 2
// MB of metadata: ~21 us at 3.35 TB/s. So one pass: a warp a (window
// page, KV head, row), eight warps a CTA; a half-warp takes a token row
// (16 lanes x 8 dims, 16-byte loads of bf16), so a warp covers two slots
// an instruction; the old pool key is read only for a valid slot the
// chunk did not write; the fold stays in registers and the two
// half-warps meet in one shuffle. No shared memory, no second pass.
// Rows never write the same slot outside scratch, and a page belongs to
// one warp, so CTAs need no ordering.
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

// One layer's operands (see the C entry points at the end).
struct Args {
  void* kv;
  void* kmax;
  void* kmin;
  const int* tab;
  const int* seq_lens;
  const unsigned char* active;
  const void* k;
  const void* v;
  const void* q;        // the rotate flag's: q [B, Hkv * G, 128] -> q_out,
  void* q_out;          // cos / sin [B, 64] f32
  const float* cosv;
  const float* sinv;
  int G, NP, page, NPB, bpp, NB;
  Fp8Codes pool_c, meta_c;
};

// Lane l of a warp owns dims 2l, 2l + 1 (i = 0, 1) and 64 + 2l, 65 + 2l
// (i = 2, 3): the two rotation pairs (2l + j, 64 + 2l + j).
__device__ __forceinline__ int lane_dim(int lane, int i) {
  return (i >> 1) * (kD / 2) + 2 * lane + (i & 1);
}

// rotate_plain of one lane's four dims of a head row x, rounded to the
// input dtype: out[j] = x1*c - x2*s, out[2 + j] = x2*c + x1*s, each
// product and sum rounded to f32 on its own (no FMA), as rope.cu.
template <int IN>
__device__ __forceinline__ void rotate4(float* x, const float* c,
                                        const float* s) {
  using In = Store<IN>;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float x1 = x[j], x2 = x[2 + j];
    x[j] = In::widen(In::narrow(
        __fsub_rn(__fmul_rn(x1, c[j]), __fmul_rn(x2, s[j])), {}));
    x[2 + j] = In::widen(In::narrow(
        __fadd_rn(__fmul_rn(x2, c[j]), __fmul_rn(x1, s[j])), {}));
  }
}

// A CTA a (KV head h, row b). Warp 0 appends head h's k and v of row b
// (rotating k first under ROTATE); under ROTATE warps 1.. rotate the
// group's q heads h * G .. h * G + G - 1 of row b, one head row a warp
// at a time.
template <int IN, int POOL, int META, bool ROTATE>
__global__ void __launch_bounds__(ROTATE ? 1024 : 32)
append_decode_kernel(Args a) {
  using In = Store<IN>;
  using Pool = Store<POOL>;
  using Meta = Store<META>;
  using InT = typename In::T;
  const int h = blockIdx.x, b = blockIdx.y, Hkv = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float c[2] = {0.f, 0.f}, s[2] = {0.f, 0.f};
  if constexpr (ROTATE) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      c[j] = a.cosv[b * (kD / 2) + 2 * lane + j];
      s[j] = a.sinv[b * (kD / 2) + 2 * lane + j];
    }
    if (warp > 0) {
      const InT* __restrict__ q = static_cast<const InT*>(a.q);
      InT* __restrict__ qo = static_cast<InT*>(a.q_out);
      const int warps = blockDim.x / 32 - 1;
      for (int g = warp - 1; g < a.G; g += warps) {
        const int64_t row = ((static_cast<int64_t>(b) * Hkv + h) * a.G + g)
                            * kD;
        float x[kPerLane];
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          x[i] = In::widen(q[row + lane_dim(lane, i)]);
        rotate4<IN>(x, c, s);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          qo[row + lane_dim(lane, i)] = In::narrow(x[i], {});
      }
      return;
    }
  }
  // Warp 0: every load that does not wait on seq_lens first (the rope's
  // inputs above, k and v), then the chain seq_lens -> table -> metadata.
  typename Pool::T* __restrict__ kv = static_cast<typename Pool::T*>(a.kv);
  typename Meta::T* __restrict__ kmax =
      static_cast<typename Meta::T*>(a.kmax);
  typename Meta::T* __restrict__ kmin =
      static_cast<typename Meta::T*>(a.kmin);
  const InT* __restrict__ k = static_cast<const InT*>(a.k);
  const InT* __restrict__ v = static_cast<const InT*>(a.v);
  const int pos = a.seq_lens[b];
  const bool act = a.active == nullptr || a.active[b] != 0;
  const int64_t src = (static_cast<int64_t>(b) * Hkv + h) * kD;
  float kf[kPerLane], vf[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    kf[i] = In::widen(k[src + lane_dim(lane, i)]);   // exact
    vf[i] = In::widen(v[src + lane_dim(lane, i)]);
  }
  const int p_log = pos / a.page, e = pos % a.page;
  const int blk = act ? a.tab[b * a.NB + min(p_log / a.bpp, a.NB - 1)] : 0;
  const int off = p_log % a.bpp;
  if constexpr (ROTATE) rotate4<IN>(kf, c, s);
  const int64_t dst = kv_row(h, blk * a.bpp + off, e, a.NP, a.page, kD);
  const int64_t meta = ((static_cast<int64_t>(h) * a.NPB + blk) * a.bpp +
                        off) * kD;
  // The old metadata (a page past its first token) before any store.
  const bool fold = act && e != 0;
  typename Meta::T old_hi[kPerLane], old_lo[kPerLane];
  if (fold) {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      old_hi[i] = kmax[meta + lane_dim(lane, i)];
      old_lo[i] = kmin[meta + lane_dim(lane, i)];
    }
  }
  typename Pool::T kq[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane_dim(lane, i);
    kq[i] = Pool::narrow(isfinite(kf[i]) ? kf[i] : 0.f, a.pool_c);
    kv[dst + d] = kq[i];
    kv[dst + static_cast<int64_t>(a.page) * kD + d] =
        Pool::narrow(isfinite(vf[i]) ? vf[i] : 0.f, a.pool_c);
  }
  if (!act) return;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int d = lane_dim(lane, i);
    const float x = Pool::widen(kq[i]);
    float hi = x, lo = x;
    if (fold) {
      hi = nan_max(Meta::widen(old_hi[i]), x);
      lo = nan_min(Meta::widen(old_lo[i]), x);
    }
    kmax[meta + d] = Meta::narrow(hi, a.meta_c);
    kmin[meta + d] = Meta::narrow(lo, a.meta_c);
  }
}

// Eight consecutive elements of a Store<C> array at element i (a
// multiple of 8, so the access is 8-, 16- or 32-byte aligned), raw.
template <int C>
__device__ __forceinline__ void load8(const void* base, int64_t i,
                                      typename Store<C>::T* raw) {
  using T = typename Store<C>::T;
  const T* p = static_cast<const T*>(base) + i;
  if constexpr (sizeof(T) == 4) {
    const float4 x = reinterpret_cast<const float4*>(p)[0];
    const float4 y = reinterpret_cast<const float4*>(p)[1];
    raw[0] = x.x; raw[1] = x.y; raw[2] = x.z; raw[3] = x.w;
    raw[4] = y.x; raw[5] = y.y; raw[6] = y.z; raw[7] = y.w;
  } else if constexpr (sizeof(T) == 2) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      raw[2 * j] = static_cast<T>(w[j] & 0xFFFFu);
      raw[2 * j + 1] = static_cast<T>(w[j] >> 16);
    }
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      raw[j] = static_cast<T>((x.x >> (8 * j)) & 0xFFu);
      raw[4 + j] = static_cast<T>((x.y >> (8 * j)) & 0xFFu);
    }
  }
}

template <int C>
__device__ __forceinline__ void store8(void* base, int64_t i,
                                       const typename Store<C>::T* raw) {
  using T = typename Store<C>::T;
  T* p = static_cast<T*>(base) + i;
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[0] =
        make_float4(raw[0], raw[1], raw[2], raw[3]);
    reinterpret_cast<float4*>(p)[1] =
        make_float4(raw[4], raw[5], raw[6], raw[7]);
  } else if constexpr (sizeof(T) == 2) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = static_cast<unsigned>(raw[2 * j]) |
             (static_cast<unsigned>(raw[2 * j + 1]) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo |= static_cast<unsigned>(raw[j]) << (8 * j);
      hi |= static_cast<unsigned>(raw[4 + j]) << (8 * j);
    }
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  }
}

// The prefill route's operands (see append_prefill_launch).
struct PrefillArgs {
  void* kv;
  void* kmax;
  void* kmin;
  const int* tab;
  const int* seq_lens;
  const int* new_lens;  // NULL: T a row
  const void* k;
  const void* v;
  int T, Hkv, NP, page, NPB, bpp, NB, P, W;
  Fp8Codes pool_c, meta_c;
};

constexpr int kPrefillWarps = 8;
constexpr float kInvalid = 3.0e38f;   // the plain version's `big`

// A warp a (window page w, KV head h) of row b = blockIdx.y; lane l takes
// dims 8 (l % 16) .. 8 (l % 16) + 7 of slots l / 16, l / 16 + 2, ...
template <int IN, int POOL, int META>
__global__ void __launch_bounds__(32 * kPrefillWarps)
append_prefill_kernel(PrefillArgs a) {
  using In = Store<IN>;
  using Pool = Store<POOL>;
  using Meta = Store<META>;
  const int unit = blockIdx.x * kPrefillWarps + threadIdx.x / 32;
  if (unit >= a.W * a.Hkv) return;
  const int h = unit % a.Hkv, w = unit / a.Hkv, b = blockIdx.y;
  const int lane = threadIdx.x % 32, half = lane >> 4, d0 = (lane & 15) * 8;
  const int offset = a.seq_lens[b];
  const int n = a.new_lens == nullptr ? a.T : a.new_lens[b];
  if (n <= 0) return;                              // inactive: no writes
  const int p0 = min(offset / a.page, a.P - a.W);
  const int local = min(max(offset - p0 * a.page, 0), a.W * a.page - a.T);
  const int start = p0 * a.page + local;
  const int lp = p0 + w, pos0 = lp * a.page;
  const int w_lo = max(start, pos0), w_hi = min(start + a.T, pos0 + a.page);
  const int end_valid = offset + n;
  const bool any_valid = pos0 < end_valid;
  if (w_lo >= w_hi && !any_valid) return;          // nothing to do here
  const int blk = a.tab[b * a.NB + lp / a.bpp], off = lp % a.bpp;
  const int64_t krow = kv_row(h, blk * a.bpp + off, 0, a.NP, a.page, kD);
  const int64_t vrow = krow + static_cast<int64_t>(a.page) * kD;
  float hi[8], lo[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    hi[i] = __uint_as_float(0xFF800000u);        // -inf
    lo[i] = __uint_as_float(0x7F800000u);        // +inf
  }
#pragma unroll 4
  for (int e = half; e < a.page; e += 2) {
    const int pos = pos0 + e;
    const bool valid = pos < end_valid;
    typename Pool::T kq[8];
    if (pos >= w_lo && pos < w_hi) {
      const int64_t src =
          ((static_cast<int64_t>(b) * a.T + (pos - start)) * a.Hkv + h) * kD
          + d0;
      typename In::T kr[8], vr[8];
      load8<IN>(a.k, src, kr);
      load8<IN>(a.v, src, vr);
      typename Pool::T vq[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float kf = In::widen(kr[i]), vf = In::widen(vr[i]);
        kq[i] = Pool::narrow(isfinite(kf) ? kf : 0.f, a.pool_c);
        vq[i] = Pool::narrow(isfinite(vf) ? vf : 0.f, a.pool_c);
      }
      store8<POOL>(a.kv, krow + static_cast<int64_t>(e) * kD + d0, kq);
      store8<POOL>(a.kv, vrow + static_cast<int64_t>(e) * kD + d0, vq);
    } else if (valid) {
      load8<POOL>(a.kv, krow + static_cast<int64_t>(e) * kD + d0, kq);
    }
    if (valid) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = Pool::widen(kq[i]);
        hi[i] = nan_max(hi[i], x);
        lo[i] = nan_min(lo[i], x);
      }
    }
  }
  if (!any_valid) return;                          // warp-uniform
  const bool some_invalid = pos0 + a.page > end_valid;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // Half-warp 0's slots first in either lane, so both halves agree.
    const float oh = __shfl_xor_sync(0xFFFFFFFFu, hi[i], 16);
    const float ol = __shfl_xor_sync(0xFFFFFFFFu, lo[i], 16);
    hi[i] = half == 0 ? nan_max(hi[i], oh) : nan_max(oh, hi[i]);
    lo[i] = half == 0 ? nan_min(lo[i], ol) : nan_min(ol, lo[i]);
    if (some_invalid) {
      hi[i] = nan_max(hi[i], -kInvalid);
      lo[i] = nan_min(lo[i], kInvalid);
    }
  }
  if (half != 0) return;
  const int64_t meta = ((static_cast<int64_t>(h) * a.NPB + blk) * a.bpp +
                        off) * kD + d0;
  typename Meta::T mh[8], ml[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mh[i] = Meta::narrow(hi[i], a.meta_c);
    ml[i] = Meta::narrow(lo[i], a.meta_c);
  }
  store8<META>(a.kmax, meta, mh);
  store8<META>(a.kmin, meta, ml);
}

template <int IN, int POOL, int META, bool ROTATE>
cudaError_t launch(const Args& a, int B, int Hkv, cudaStream_t stream) {
  const int warps = ROTATE ? 1 + (a.G < 31 ? a.G : 31) : 1;
  append_decode_kernel<IN, POOL, META, ROTATE>
      <<<dim3(Hkv, B), 32 * warps, 0, stream>>>(a);
  return cudaGetLastError();
}

// The dtype codes as template arguments: by_codes(in, kv, meta, f) calls
// f(Codes<IN, POOL, META>{}) for the codes given (0 f32, 1 bf16, 2 fp8).
template <int I, int P, int M>
struct Codes {
  static constexpr int in = I, pool = P, meta = M;
};

template <int IN, int POOL, typename F>
cudaError_t with_meta(int meta_code, const F& f) {
  switch (meta_code) {
    case 0: return f(Codes<IN, POOL, 0>{});
    case 1: return f(Codes<IN, POOL, 1>{});
    case 2: return f(Codes<IN, POOL, 2>{});
    default: return cudaErrorInvalidValue;
  }
}

template <int IN, typename F>
cudaError_t with_pool(int kv_code, int meta_code, const F& f) {
  switch (kv_code) {
    case 0: return with_meta<IN, 0>(meta_code, f);
    case 1: return with_meta<IN, 1>(meta_code, f);
    case 2: return with_meta<IN, 2>(meta_code, f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
int by_codes(int in_code, int kv_code, int meta_code, const F& f) {
  switch (in_code) {   // the input: f32 or bf16
    case 0: return static_cast<int>(with_pool<0>(kv_code, meta_code, f));
    case 1: return static_cast<int>(with_pool<1>(kv_code, meta_code, f));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool ROTATE>
int dispatch(int in_code, int kv_code, int meta_code, const Args& a, int B,
             int Hkv, void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || a.page < 1 || a.bpp < 1 ||
      a.NB < 1 || a.NPB < 1 || a.NP != a.NPB * a.bpp)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_codes(in_code, kv_code, meta_code, [&](auto c) {
    using C = decltype(c);
    return launch<C::in, C::pool, C::meta, ROTATE>(a, B, Hkv, s);
  });
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
  const Args a{kv, kmax, kmin, tab, seq_lens, active, k, v, nullptr,
               nullptr, nullptr, nullptr, 1, NP, page, NPB, bpp, NB,
               {static_cast<unsigned>(pool_ovf),
                static_cast<unsigned>(pool_carry)},
               {static_cast<unsigned>(meta_ovf),
                static_cast<unsigned>(meta_carry)}};
  return dispatch<false>(in_code, kv_code, meta_code, a, B, Hkv, stream);
}

// The same append with the decode rope in its launch: q [B, Hkv * G, 128]
// rotated into q_out, k rotated (and rounded to the input dtype) before
// it is appended; cos / sin [B, 64] f32, one pair a row. q, q_out, k and
// v of dtype in_code.
extern "C" int rope_append_launch(void* kv, void* kmax, void* kmin,
                                  const int* tab, const int* seq_lens,
                                  const unsigned char* active, const void* q,
                                  const void* k, const void* v, void* q_out,
                                  const float* cosv, const float* sinv,
                                  int B, int Hkv, int G, int NP, int page,
                                  int NPB, int bpp, int NB, int in_code,
                                  int kv_code, int meta_code, int pool_ovf,
                                  int pool_carry, int meta_ovf,
                                  int meta_carry, void* stream) {
  if (G < 1 || q == nullptr || q_out == nullptr || cosv == nullptr ||
      sinv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{kv, kmax, kmin, tab, seq_lens, active, k, v, q, q_out, cosv,
               sinv, G, NP, page, NPB, bpp, NB,
               {static_cast<unsigned>(pool_ovf),
                static_cast<unsigned>(pool_carry)},
               {static_cast<unsigned>(meta_ovf),
                static_cast<unsigned>(meta_carry)}};
  return dispatch<true>(in_code, kv_code, meta_code, a, B, Hkv, stream);
}

// The prefill route: k / v [B, T, Hkv, 128] (in_code), new_lens [B] int32
// or NULL (T a row), P logical pages a row (NB * bpp at most), W =
// min(P, T / page + 2) window pages; T must fit the window (T <= W *
// page). The other arguments as append_decode_launch's.
extern "C" int append_prefill_launch(void* kv, void* kmax, void* kmin,
                                     const int* tab, const int* seq_lens,
                                     const int* new_lens, const void* k,
                                     const void* v, int B, int T, int Hkv,
                                     int NP, int page, int NPB, int bpp,
                                     int NB, int P, int W, int in_code,
                                     int kv_code, int meta_code,
                                     int pool_ovf, int pool_carry,
                                     int meta_ovf, int meta_carry,
                                     void* stream) {
  if (B < 1 || B > 65535 || T < 1 || Hkv < 1 || page < 1 || bpp < 1 ||
      NB < 1 || NPB < 1 || NP != NPB * bpp || P < 1 || P > NB * bpp ||
      W < 1 || W > P || static_cast<int64_t>(W) * page < T ||
      static_cast<int64_t>(P) * page > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const PrefillArgs a{kv, kmax, kmin, tab, seq_lens, new_lens, k, v, T, Hkv,
                      NP, page, NPB, bpp, NB, P, W,
                      {static_cast<unsigned>(pool_ovf),
                       static_cast<unsigned>(pool_carry)},
                      {static_cast<unsigned>(meta_ovf),
                       static_cast<unsigned>(meta_carry)}};
  const dim3 grid((W * Hkv + kPrefillWarps - 1) / kPrefillWarps, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_codes(in_code, kv_code, meta_code, [&](auto c) {
    using C = decltype(c);
    append_prefill_kernel<C::in, C::pool, C::meta>
        <<<grid, 32 * kPrefillWarps, 0, s>>>(a);
    return cudaGetLastError();
  });
}
