"""Quest's decode attention: the page estimate, the top-k select, and
the sparse and dense decode kernels (``csrc/{estimate,topk_select,
sparse_decode,dense_decode,fused_decode}.cu``; sparse and dense decode
are one kernel, ``decode_ring``). Work: ``bench.work.decode_attention``
of each decode step of a tick."""

from bench.work import decode_attention, decode_steps_of, doc_tokens_of

KERNELS = ("estimate_physical_kernel", "estimate_kernel",
           "topk_select_kernel", "decode_ring", "decode_partial",
           "decode_merge", "fused_decode_kernel")


def work(rec, tick):
    if tick.kind != "decode":
        return 0.0, 0.0
    docs = doc_tokens_of(rec)
    f = b = 0.0
    for rows in decode_steps_of(tick):
        df, db = decode_attention(rec.dims, rec.quest, rows, docs, rec.here)
        f, b = f + df, b + db
    return f, b
