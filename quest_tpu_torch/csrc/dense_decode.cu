// Dense paged flash-decode attention over every cached token of a slot.
//
// Replaces quest_tpu/ops/dense_decode.py:dense_decode_attention (the
// Pallas kernels _kernel and _kernel_shared, pallas_call at line 181),
// which streamed one allocation block (block_pages pages) per
// sequential grid step through the block table. Here the logical pages
// of a slot are cut into splits of per_split pages, each split goes to
// its own CTA, every page is mapped through the block table
// (tab[b, p / bpp] * bpp + p % bpp), tokens >= seq_len are masked (the
// sequence may end inside a block or a page), and the splits are merged
// by log-sum-exp: in the same launch over bf16 and fp8 pools
// (decode_common.cuh: decode_ring, which also brings each split's pages
// in through a ring of TMA or bulk copies and attends on the tensor
// cores), by a second small kernel over f32 pools. The grid is sized from
// the block table's capacity and the SM count (no host read of seq_lens;
// ops/decode_common.py:decode_plan, three CTAs an SM for a full table);
// splits past a row's pages exit at once.
//
// Window layers (window > 0) attend only the last `window` keys of a
// row: its pages start at that of key seq_len - window, the keys below it
// are masked, and the plan's splits cover the window's pages alone.
//
// Bound on the H100: bytes. Every K and V row of the slot is read once
// per KV head: 8 heads x 32768 tokens x 512 bytes = 134 MB for one
// 32K-token row of Llama-3.1-8B in bf16 (half that from an fp8 e4m3
// pool), against 3.35 TB/s. The G query heads of a group share each row
// read; the splits put hundreds of CTAs in flight so that the loads of
// many SMs overlap.
#include "decode_common.cuh"

extern "C" int dense_decode_launch(
    const void* q, const void* kv, const int* tab, const int* seq_lens,
    float* part_o, float* part_ml, int* tickets, float* out, int B, int Hkv,
    int G, int NP, int page, int NB, int bpp, int nsplit, int per_split,
    int kv_dtype, float sm_scale, int q_bf16, int window, const void* tmap,
    void* stream) {
  qt::DecodeArgs a{q,       kv,      tab,     seq_lens, nullptr, nullptr,
                   part_o,  part_ml, tickets, out,      Hkv,     1,
                   NP,      page,    NB,      bpp,      0,       nsplit,
                   per_split, sm_scale, q_bf16, G,      sub_groups(G),
                   window};
  return qt::dispatch_decode<false>(a, tmap, B, kv_dtype, stream);
}
