"""Eager oracles (counterpart of ``quest_tpu/ops/reference.py``).

Full score matrices in f32; testing only, never the serving path.
"""

from __future__ import annotations

import torch

_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _softmax_attend(scores: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    # scores [..., T]; v [..., T, D]
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    return (torch.einsum("...t,...td->...d", p, v)
            / p.sum(dim=-1, keepdim=True))


def dense_decode_attention_reference(q, k_flat, v_flat, seq_lens,
                                     sm_scale: float) -> torch.Tensor:
    """Single-query attention over the first ``seq_len`` cached tokens.

    q: [B, Hq, D]; k_flat/v_flat: [B, Hkv, T, D]; seq_lens: [B].
    Returns [B, Hq, D] f32.
    """
    B, Hq, D = q.shape
    Hkv, T = k_flat.shape[1], k_flat.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Hkv, G, D) * sm_scale
    scores = torch.einsum("bkgd,bktd->bkgt", qf, k_flat.float())
    tok = torch.arange(T, device=q.device)[None, None, None, :]
    scores = torch.where(tok < seq_lens[:, None, None, None], scores,
                         torch.tensor(_MASK_VALUE, device=q.device))
    out = _softmax_attend(scores, v_flat.float()[:, :, None])
    return out.reshape(B, Hq, D)


def sparse_decode_attention_reference(q, k_pages, v_pages, indices,
                                      num_valid, seq_lens,
                                      sm_scale: float) -> torch.Tensor:
    """Attention restricted to the selected pages per KV head.

    q: [B, Hq, D]; k_pages/v_pages: [B, Hkv, P, page, D];
    indices: [B, Hkv, S]; num_valid: [B]; seq_lens: [B].
    Returns [B, Hq, D] f32.
    """
    B, Hq, D = q.shape
    _, Hkv, P, page, _ = k_pages.shape
    S = indices.shape[-1]
    G = Hq // Hkv
    qf = q.float().reshape(B, Hkv, G, D) * sm_scale
    safe = indices.long().clamp(0, P - 1)[..., None, None].expand(
        B, Hkv, S, page, D)
    k_sel = torch.gather(k_pages, 2, safe).float().reshape(B, Hkv, S * page, D)
    v_sel = torch.gather(v_pages, 2, safe).float().reshape(B, Hkv, S * page, D)
    scores = torch.einsum("bkgd,bktd->bkgt", qf, k_sel)
    slot = torch.arange(S, device=q.device)[None, None, :, None]
    entry = torch.arange(page, device=q.device)[None, None, None, :]
    global_tok = indices.long()[..., None] * page + entry
    valid = ((slot < num_valid[:, None, None, None])
             & (global_tok < seq_lens[:, None, None, None]))
    valid = valid.reshape(B, Hkv, 1, S * page)
    scores = torch.where(valid, scores,
                         torch.tensor(_MASK_VALUE, device=q.device))
    out = _softmax_attend(scores, v_sel[:, :, None])
    return out.reshape(B, Hq, D)


def prefill_attention_reference(q, k_flat, v_flat, q_offsets, kv_lens,
                                sm_scale: float) -> torch.Tensor:
    """Causal attention of T fresh queries over the cache: query i of
    sequence b sits at ``q_offsets[b] + i``. q: [B, T, Hq, D];
    k_flat/v_flat: [B, Hkv, Tkv, D]. Returns [B, T, Hq, D] f32."""
    B, T, Hq, D = q.shape
    Hkv, Tkv = k_flat.shape[1], k_flat.shape[2]
    G = Hq // Hkv
    qf = (q.float() * sm_scale).permute(0, 2, 1, 3).reshape(B, Hkv, G, T, D)
    scores = torch.einsum("bkgqd,bktd->bkgqt", qf, k_flat.float())
    q_pos = q_offsets[:, None] + torch.arange(T, device=q.device)[None, :]
    tok = torch.arange(Tkv, device=q.device)[None, :]
    mask = ((tok[:, None, :] <= q_pos[:, :, None])
            & (tok[:, None, :] < kv_lens[:, None, None]))
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(_MASK_VALUE, device=q.device))
    out = _softmax_attend(scores, v_flat.float()[:, :, None, None])
    return out.reshape(B, Hq, T, D).permute(0, 2, 1, 3)


def estimate_reference(q, k_min, k_max) -> torch.Tensor:
    """score[h,p] = sum_d max(q_d*maxK_d, q_d*minK_d). Returns [B, Hq, P]."""
    B, Hq, D = q.shape
    Hkv = k_min.shape[1]
    G = Hq // Hkv
    qf = q.float().reshape(B, Hkv, G, 1, D)
    prod_max = qf * k_max.float()[:, :, None]
    prod_min = qf * k_min.float()[:, :, None]
    return torch.maximum(prod_max, prod_min).sum(-1).reshape(B, Hq, -1)


def selection_flips(ids, want_ids, scores, num_pages):
    """Compare a selection with the plain version's, per row of [R, K]
    ids: returns (the number of selected ids in one selection and not
    the other, the largest relative distance of such a page's score from
    the K-th score). ``scores`` [R, P] are the plain scores, ``num_pages``
    [R] the rows' pages; the K-th score is the lowest the plain version
    selected apart from the always-kept last page."""
    ids, want_ids = ids.cpu().long(), want_ids.cpu().long()
    scores, num_pages = scores.cpu().float(), num_pages.cpu().long()
    count, worst = 0, 0.0
    for r in range(ids.shape[0]):
        n = int(num_pages[r])
        nv = min(ids.shape[1], n)
        got, want = set(ids[r, :nv].tolist()), set(want_ids[r, :nv].tolist())
        diff = sorted(got ^ want)
        if not diff:
            continue
        kth = float(scores[r, sorted(want - {n - 1})].min())
        count += len(diff)
        for p in diff:
            worst = max(worst, abs(float(scores[r, p]) - kth)
                        / max(abs(kth), 1e-30))
    return count, worst
