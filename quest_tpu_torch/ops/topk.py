"""Top-K page selection (counterpart of ``quest_tpu/ops/topk.py``).

The last (current) page scores +inf and invalid pages -inf, then one
static-width top-K over all pages selects {last} ∪ top-(K-1) of the
rest. Trailing slots of short sequences hold -inf scores; ``num_valid``
says how many slots are real, which also covers the dense fallback.

``lax.top_k`` breaks ties toward the lowest index and ``torch.topk``
promises no order, so the plain version takes the first K of a STABLE
descending sort: the selected ids then equal the JAX package's bit for
bit. On a CUDA tensor :func:`select_pages` is one launch of
``csrc/topk_select.cu`` (``ops/fused_decode.py:exact_topk_select`` with
the junk id P - 1), which gives the same ids and ``num_valid``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from quest_tpu_torch.ops.fused_decode import exact_topk_select


def serving_method(pool_pages: int, budget_pages: int) -> str:
    """The serving config's selection rule, as ``quest_tpu`` names it.
    The port runs every method as exact top-k."""
    return "exact_fast" if pool_pages <= 16 * budget_pages else "approx"


def select_pages(scores: torch.Tensor, seq_lens: torch.Tensor,
                 page_size: int,
                 budget_pages: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the top-``budget_pages`` pages per (batch, head), exactly.

    scores: [B, H, P] f32 (garbage OK at invalid pages); seq_lens: [B]
    lengths including the token being decoded, ceil(seq_lens /
    page_size) <= P.

    Returns (indices [B, H, K] int32, num_valid [B] int32). Valid slots
    are in ascending page id, so the current page sits at slot
    ``num_valid - 1``; slots >= num_valid are junk and all hold P - 1.
    On a CUDA tensor one select kernel launch; on a CPU tensor
    :func:`select_pages_plain`.
    """
    if not scores.is_cuda:
        return select_pages_plain(scores, seq_lens, page_size, budget_pages)
    B, H, P = scores.shape
    ids, num_valid = exact_topk_select(
        scores.reshape(B * H, P), seq_lens, budget_pages, junk=P - 1,
        page_size=page_size, rows_per_len=H)
    return ids.reshape(B, H, budget_pages), num_valid


def select_pages_plain(scores: torch.Tensor, seq_lens: torch.Tensor,
                       page_size: int, budget_pages: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eager version of :func:`select_pages`, as the JAX package's
    ``select_pages`` computes it (two stable sorts)."""
    B, H, P = scores.shape
    pool_pages = P
    if budget_pages > P:
        scores = torch.nn.functional.pad(scores, (0, budget_pages - P),
                                         value=float("-inf"))
        P = budget_pages
    seq_lens = seq_lens.to(torch.int64)
    num_pages = (seq_lens + page_size - 1) // page_size          # [B]
    page_ids = torch.arange(P, device=scores.device)[None, None, :]
    s = torch.where(page_ids < num_pages[:, None, None], scores,
                    torch.full_like(scores, float("-inf")))
    s = torch.where(page_ids == (num_pages - 1)[:, None, None],
                    torch.full_like(s, float("inf")), s)
    indices = torch.sort(s, dim=-1, descending=True,
                         stable=True).indices[..., :budget_pages]
    indices = indices.clamp(0, pool_pages - 1)
    num_valid = num_pages.clamp(max=budget_pages)
    # Key junk slots past every real page id so they sort to the tail,
    # then clamp the sorted keys back into the pool range.
    slot = torch.arange(budget_pages, device=scores.device)[None, None, :]
    key = torch.where(slot < num_valid[:, None, None], indices,
                      indices + 2 * pool_pages)
    indices = torch.sort(key, dim=-1).values.clamp(max=pool_pages - 1)
    return indices.to(torch.int32), num_valid.to(torch.int32)
