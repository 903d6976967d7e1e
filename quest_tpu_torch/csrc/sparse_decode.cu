// Sparse paged flash-decode attention over the selected pages.
//
// Replaces quest_tpu/ops/sparse_decode.py:sparse_decode_attention (the
// Pallas kernels _kernel and _kernel_1blk, pallas_call at line 498).
// For each (batch row, selection head) it reads the S selected LOGICAL
// pages, maps each through the block table to its physical page
// (tab[b, p / bpp] * bpp + p % bpp), and attends the G query heads of
// the group over those S * page tokens. Slots >= num_valid are junk
// (select_pages leaves them all on page P-1) and are masked by slot;
// the current page's tail is masked by token position (< seq_len), so
// the kernel needs no "last slot" search. In per-query-head mode the
// selection head is a query head (G = 1) that reads KV head h / kvdiv.
// Any G: groups pad to 1, 2, 4, 8 or 16 heads a CTA, and run sub-groups
// of 16 above that (decode_common.cuh).
//
// Bound on the H100: bytes. Each selected page is read once per
// selection head (2 * page * D * 2 bytes in bf16, 8 KB at page 16),
// about 8.4 MB for one row of Llama-3.1-8B at S = 128, against
// 3.35 TB/s. The G query heads share every page read. The slots are
// split across CTAs (ops/decode_common.py:decode_plan: the batch's
// selections spread over one CTA an SM, at least 128 tokens a split, 8
// splits of 16 slots a (row, KV head) at B=2 on 132 SMs) so that one row
// fills the card instead of Hkv SMs. Over bf16 and fp8 pools each CTA
// keeps its split's pages in flight at once (a ring of TMA or bulk
// copies), attends on the tensor cores in warp-private 16-token chunks,
// and the splits merge in the same launch (decode_common.cuh:
// decode_ring). fp8 e4m3 pools read half the bytes.
#include "decode_common.cuh"

extern "C" int sparse_decode_launch(
    const void* q, const void* kv, const int* tab, const int* seq_lens,
    const int* indices, const int* num_valid, float* part_o, float* part_ml,
    int* tickets, float* out, int B, int Hsel, int G, int kvdiv, int NP,
    int page, int NB, int bpp, int S, int nsplit, int per_split, int kv_dtype,
    float sm_scale, int q_bf16, const void* tmap, void* stream) {
  qt::DecodeArgs a{q,      kv,      tab,     seq_lens, indices, num_valid,
                   part_o, part_ml, tickets, out,      Hsel,    kvdiv,
                   NP,     page,    NB,      bpp,      S,       nsplit,
                   per_split, sm_scale, q_bf16, G,     sub_groups(G)};
  return qt::dispatch_decode<true>(a, tmap, B, kv_dtype, stream);
}
