"""Causal prefill attention over the paged cache (``csrc/prefill.cu``:
the TMA + wgmma kernel for bf16 and fp8 pools, the FMA kernel for the
rest). Work: ``bench.work.prefill_attention`` of a prefill tick's real
tokens."""

from bench.work import doc_tokens_of, prefill_attention

KERNELS = ("prefill_tma_kernel", "prefill_fma_kernel")


def work(rec, tick):
    if tick.kind != "prefill":
        return 0.0, 0.0
    return prefill_attention(rec.dims, rec.quest, tick.prefill_rows,
                             doc_tokens_of(rec), rec.here)
