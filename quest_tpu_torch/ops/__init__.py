from quest_tpu_torch.ops.dense_decode import dense_decode_attention
from quest_tpu_torch.ops.estimate import (page_scores, page_scores_kernel,
                                          page_scores_per_qhead,
                                          page_scores_physical)
from quest_tpu_torch.ops.fused_decode import (exact_topk_select,
                                              fused_sparse_decode)
from quest_tpu_torch.ops.prefill import prefill_attention
from quest_tpu_torch.ops.rms_norm import rms_norm
from quest_tpu_torch.ops.rope import apply_rope, compute_rope_params
from quest_tpu_torch.ops.sparse_decode import sparse_decode_attention
from quest_tpu_torch.ops.topk import select_pages

__all__ = [
    "apply_rope", "compute_rope_params", "dense_decode_attention",
    "exact_topk_select", "fused_sparse_decode", "page_scores",
    "page_scores_kernel", "page_scores_per_qhead", "page_scores_physical",
    "prefill_attention", "rms_norm", "select_pages",
    "sparse_decode_attention",
]
