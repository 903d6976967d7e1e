"""Accuracy simulation of Quest attention over the full score matrix
(counterpart of ``quest_tpu/evals/sim_attention.py``), in plain PyTorch.

As the reference's eval-only attention patch
(``evaluation/quest_attention.py``): per *query* head, the keys are cut
into chunks, each chunk is scored with the sign-trick upper bound, the
top ``max(3, budget // chunk)`` chunks are kept, and the softmax runs
over the surviving tokens only. It cross-checks the kernel path's
selection and reproduces the paper's accuracy protocol (per-query-head
selection, the budget clamped to the sequence; the caller keeps the
first two layers dense).

O(T^2) memory: accuracy experiments only.
"""

from __future__ import annotations

import torch

_NEG = -0.7 * float(torch.finfo(torch.float32).max)


def quest_sim_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        token_budget: int, chunk_size: int,
                        sm_scale: float) -> torch.Tensor:
    """Single-token decode attention with Quest chunk selection.

    q: [B, Hq, D] (rope applied); k/v: [B, Hq, T, D] (KV heads already
    repeated to the query heads). Returns [B, Hq, D] f32. Chunks that tie
    on their score are taken lowest index first, as ``lax.top_k`` does.
    """
    B, Hq, D = q.shape
    T = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()

    scores = torch.einsum("bhd,bhtd->bht", qf, kf) * sm_scale

    # Sign-trick chunk max: maxK = K * sign(q), q+ = q * sign(q).
    sign = torch.where(qf > 0, 1.0, -1.0)
    max_key = kf * sign[:, :, None, :]
    q_pos = qf * sign

    pad = (-T) % chunk_size
    max_key = torch.nn.functional.pad(max_key, (0, 0, 0, pad), value=_NEG)
    n_chunks = (T + pad) // chunk_size
    chunk_max = max_key.reshape(B, Hq, n_chunks, chunk_size, D).amax(dim=3)
    chunk_score = torch.einsum("bhd,bhcd->bhc", q_pos, chunk_max)

    # The reference's chunk count: min(max(3, budget // chunk), n_chunks).
    budget = min(token_budget, T)
    k_chunks = min(max(3, budget // chunk_size), n_chunks)
    order = torch.sort(chunk_score, dim=-1, descending=True, stable=True)
    top_idx = order.indices[..., :k_chunks]

    keep = torch.zeros((B, Hq, n_chunks), dtype=torch.bool, device=q.device)
    keep.scatter_(-1, top_idx, True)
    keep_tok = keep.repeat_interleave(chunk_size, dim=-1)[..., :T]

    masked = torch.where(keep_tok, scores, torch.full_like(scores, _NEG))
    m = masked.amax(dim=-1, keepdim=True)
    p = torch.exp(masked - m)
    out = torch.einsum("bht,bhtd->bhd", p, vf)
    return out / p.sum(dim=-1, keepdim=True)
