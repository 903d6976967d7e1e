"""Fused Quest decode: estimate -> exact top-K -> decode in one launch
(counterpart of ``quest_tpu/ops/fused_decode.py``).

:func:`exact_topk_select` is the fused kernel's select stage on its own
(``csrc/topk_select.cu``, the counterpart of ``_exact_topk_select`` +
``_compact_ids``); :func:`fused_sparse_decode` is the whole pipeline
(``csrc/fused_decode.cu``) in the shared whole-pool mode the model uses.
On CUDA tensors they launch the kernels; on CPU tensors they run the
plain versions beside them.

The fused contract is not the unfused pipeline's in two places: the
estimate rounds relu(q) and min(q, 0) to the metadata dtype
(``estimate.page_scores_kernel_plain``), and attention rounds the
un-scaled q to the metadata dtype and multiplies the f32 QK scores by
``sm_scale`` (the sparse kernel scales q in f32 before rounding it).
"""

from __future__ import annotations

import torch

from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.estimate import page_scores_kernel_plain
from quest_tpu_torch.ops.utils import (MASK_VALUE, check_kernel_operands,
                                      check_pool_dtype, compute_dtype,
                                      kernel_query)

# Selection slots the CUDA kernel holds (the model's gate: page_budget
# <= 256).
MAX_BUDGET = 256


def order_keys(scores: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 images of f32 scores, the JAX kernel's
    ``b < 0 ? b ^ 0x7fffffff : b``: integer order is score order, except
    that -0.0 orders below +0.0."""
    b = scores.float().contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _check_rows(num_pages: torch.Tensor, R: int, page_size: int,
                rows_per_len: int) -> None:
    """num_pages must hold one entry a ``rows_per_len`` rows of R (a [B]
    vector where [B * Hkv] is meant would be read past on the card)."""
    if rows_per_len < 1 or R % rows_per_len or page_size < 1:
        raise ValueError(f"{R} rows do not take num_pages {rows_per_len} "
                         f"rows apiece in pages of {page_size}")
    if tuple(num_pages.shape) != (R // rows_per_len,):
        raise ValueError(f"num_pages must have shape ({R // rows_per_len},),"
                         f" one entry a {rows_per_len} rows of scores; got "
                         f"{tuple(num_pages.shape)}")


def exact_topk_select_plain(scores: torch.Tensor, num_pages: torch.Tensor,
                            budget_pages: int, *, junk: int = 0,
                            page_size: int = 1, rows_per_len: int = 1):
    """Eager version of :func:`exact_topk_select`: the first K of a
    stable descending sort of the keys, re-sorted by page id."""
    R, P = scores.shape
    _check_rows(num_pages, R, page_size, rows_per_len)
    K = budget_pages
    dev = scores.device
    n = ((num_pages.long().clamp(min=0) + page_size - 1) // page_size
         ).repeat_interleave(rows_per_len).clamp(max=P)
    pid = torch.arange(P, device=dev)[None, :]
    s = torch.where(pid < n[:, None], scores.float(),
                    torch.full_like(scores, float("-inf"), dtype=torch.float32))
    s = torch.where(pid == (n - 1)[:, None], torch.full_like(s, float("inf")),
                    s)
    order = torch.sort(order_keys(s).long(), dim=-1, descending=True,
                       stable=True).indices[:, :K]
    if K > P:
        order = torch.nn.functional.pad(order, (0, K - P))
    num_valid = n.clamp(max=K)
    slot = torch.arange(K, device=dev)[None, :]
    valid = slot < num_valid[:, None]
    ids = torch.sort(torch.where(valid, order, P + slot), dim=-1).values
    ids = torch.where(valid, ids, torch.full_like(ids, junk))
    return ids.to(torch.int32), num_valid[::rows_per_len].to(torch.int32)


def exact_topk_select(scores: torch.Tensor, num_pages: torch.Tensor,
                      budget_pages: int, *, junk: int = 0,
                      page_size: int = 1, rows_per_len: int = 1):
    """Exact top-K pages per row, in ascending page order.

    scores: [R, P] f32; num_pages: [R / rows_per_len] pages of each
    row, row r taking entry r // rows_per_len; with ``page_size`` > 1
    the entries are lengths in tokens, and a row's pages ceil(len /
    page_size); a row's pages must not pass P. Pages >= num_pages score
    -inf and the last page (num_pages - 1) +inf; the K largest
    order-preserving keys (:func:`order_keys`) are selected, ties at the
    boundary going to the lowest page ids (``lax.top_k``'s policy).
    Returns (ids [R, K] int32, num_valid [R / rows_per_len] int32):
    num_valid = min(K, num_pages) ids ascend in the first slots, and
    every junk slot holds ``junk`` (page 0 for the fused kernel's probe;
    P - 1 where it stands in for ``ops/topk.py:select_pages``).
    """
    R, P = scores.shape
    if not scores.is_cuda:
        return exact_topk_select_plain(scores, num_pages, budget_pages,
                                       junk=junk, page_size=page_size,
                                       rows_per_len=rows_per_len)
    _check_rows(num_pages, R, page_size, rows_per_len)
    if scores.dtype != torch.float32:
        raise TypeError(f"scores must be float32, got {scores.dtype}")
    if num_pages.device != scores.device:
        raise ValueError("num_pages must be on the scores' device")
    K = budget_pages
    s = scores.contiguous()
    n = num_pages.to(torch.int32).contiguous()
    ids = torch.empty((R, K), dtype=torch.int32, device=s.device)
    num_valid = torch.empty((R // rows_per_len,), dtype=torch.int32,
                            device=s.device)
    lib = _build.load("topk_select")
    code = lib.topk_select_launch(_build.ptr(s), _build.ptr(n),
                                  _build.ptr(ids), _build.ptr(num_valid), R,
                                  P, K, rows_per_len, page_size, junk,
                                  _build.stream_of(s))
    _build.check(lib, code, "topk_select")
    exact_topk_select.launches += 1
    return ids, num_valid


exact_topk_select.launches = 0


def _physical_pages(block_tab, block_pages: int) -> torch.Tensor:
    """Physical page of each logical page of each slot: [B, P] int64."""
    B = block_tab.shape[0]
    return (block_tab.long()[:, :, None] * block_pages
            + torch.arange(block_pages, device=block_tab.device)).reshape(B, -1)


def slot_page_scores(q, k_max, k_min, *, layer: int, block_tab,
                     block_pages: int, group_agg: str = "sum"):
    """The fused kernel's estimate of every logical page of every slot,
    eagerly: :func:`estimate.page_scores_kernel_plain` over the physical
    metadata [L, Hkv, NPB, block_pages, D] read through the block table.
    Returns [B, Hkv, P] f32, P = NB * block_pages."""
    Hkv, D = k_max.shape[1], k_max.shape[-1]
    phys = _physical_pages(block_tab, block_pages)
    km = k_max[layer].reshape(Hkv, -1, D)[:, phys].transpose(0, 1)
    kn = k_min[layer].reshape(Hkv, -1, D)[:, phys].transpose(0, 1)
    return page_scores_kernel_plain(q, km, kn, group_agg)


def fused_sparse_decode_plain(q, kv_pages, k_max, k_min, seq_lens, *,
                              sm_scale: float, budget_pages: int,
                              group_agg: str = "sum", layer: int, block_tab,
                              block_pages: int, return_ids: bool = False):
    """Eager version of the fused kernel's contract: the streaming
    estimate over each slot's metadata read through the block table,
    :func:`exact_topk_select`, then one softmax over the selected pages
    with q rounded to the metadata dtype and un-scaled, K and V cast to
    that dtype, ``sm_scale`` on the f32 scores, slots >= num_valid and
    tokens >= seq_len masked (which masks the last page's tail wherever
    it sits), p rounded to that dtype before PV and ``pv / l``."""
    kvl = kv_pages[layer]                            # [Hkv, NP, 2, page, D]
    Hkv, NP, _, page, D = kvl.shape
    B, Hq, _ = q.shape
    G = Hq // Hkv
    K = budget_pages
    dev = q.device
    phys = _physical_pages(block_tab, block_pages)              # [B, P]
    P = phys.shape[1]
    scores = slot_page_scores(q, k_max, k_min, layer=layer,
                              block_tab=block_tab, block_pages=block_pages,
                              group_agg=group_agg)             # [B, Hkv, P]
    num_pages = (seq_lens.long() + page - 1) // page
    ids, num_valid = exact_topk_select_plain(
        scores.reshape(B * Hkv, P), num_pages.repeat_interleave(Hkv), K)
    ids = ids.reshape(B, Hkv, K).long()
    num_valid = num_valid.reshape(B, Hkv)[:, 0].long()

    cdt = compute_dtype(k_max.dtype)
    qa = q.float().to(cdt).float().reshape(B, Hkv, G, D)
    sel_phys = torch.gather(phys, 1, ids.reshape(B, -1)).reshape(B, Hkv, K)
    sel = kvl[torch.arange(Hkv, device=dev)[None, :, None], sel_phys]
    k = sel[:, :, :, 0].reshape(B, Hkv, K * page, D).to(cdt).float()
    v = sel[:, :, :, 1].reshape(B, Hkv, K * page, D).to(cdt).float()
    s = torch.einsum("bhgd,bhtd->bhgt", qa, k) * sm_scale
    slot = torch.arange(K, device=dev)[None, None, :, None]
    entry = torch.arange(page, device=dev)[None, None, None, :]
    valid = ((slot < num_valid[:, None, None, None])
             & (ids[..., None] * page + entry
                < seq_lens.long()[:, None, None, None]))
    valid = valid.reshape(B, Hkv, 1, K * page)
    s = torch.where(valid, s, torch.full_like(s, MASK_VALUE))
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                    torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgt,bhtd->bhgd", p.to(cdt).float(), v)
    o = torch.where(l > 0, o / l, torch.zeros_like(o)).reshape(B, Hq, D)
    return (o, ids.to(torch.int32)) if return_ids else o


def fused_sparse_decode(q, kv_pages, k_max, k_min, seq_lens, *,
                        sm_scale: float, budget_pages: int,
                        group_agg: str = "sum", layer: int, block_tab,
                        block_pages: int, return_ids: bool = False):
    """Quest decode attention of one layer as one fused launch.

    q: [B, Hq, D] un-scaled; kv_pages: the shared pool [L, Hkv, NP, 2,
    page, D] and k_max/k_min its physical-page metadata [L, Hkv, NPB,
    block_pages, D], read at ``layer``; seq_lens: [B] including the
    current token; block_tab: [B, NB]. Returns [B, Hq, D] f32 (see
    :func:`fused_sparse_decode_plain` for the contract); with
    ``return_ids`` also the selected logical page ids [B, Hkv, K] int32
    (ascending, junk slots 0), for checking the kernel's selection.
    """
    if group_agg not in ("max", "sum"):
        raise ValueError(f"unknown group_agg {group_agg!r}")
    kw = dict(sm_scale=sm_scale, budget_pages=budget_pages,
              group_agg=group_agg, layer=layer, block_tab=block_tab,
              block_pages=block_pages, return_ids=return_ids)
    if not q.is_cuda:
        return fused_sparse_decode_plain(q, kv_pages, k_max, k_min, seq_lens,
                                         **kw)
    if max(check_pool_dtype(kv_pages.dtype),
           check_pool_dtype(k_max.dtype, "page metadata")) > 1:
        raise NotImplementedError(
            "the fused kernel takes bf16 or f32 pools and metadata; "
            "QuestConfig refuses fp8 with fused_decode=True")
    if k_min.dtype != k_max.dtype or k_min.shape != k_max.shape:
        raise ValueError("k_max and k_min must share dtype and shape")
    K = budget_pages
    if not 1 <= K <= MAX_BUDGET:
        raise NotImplementedError(
            f"the fused kernel holds 1..{MAX_BUDGET} selection slots, got {K}")
    B, Hq, D = q.shape
    _, Hkv, NP, _, page, _ = kv_pages.shape
    G = check_kernel_operands(q, Hkv, kv_pages, k_max, k_min)
    if k_max.shape[1:] != (Hkv, NP // block_pages, block_pages, D):
        raise ValueError(f"metadata {tuple(k_max.shape)} does not match the "
                         f"pool {tuple(kv_pages.shape)}")
    for t in (block_tab, seq_lens):
        if t.device != q.device:
            raise ValueError("all operands must be on the query's device")
    NB = block_tab.shape[1]
    qk = kernel_query(q)
    tab = block_tab.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    ids = (torch.empty((B, Hkv, K), dtype=torch.int32, device=q.device)
           if return_ids else None)
    lib = _build.load("fused_decode")
    code = lib.fused_decode_launch(
        _build.ptr(qk), _build.ptr(kv_pages[layer]), _build.ptr(k_max[layer]),
        _build.ptr(k_min[layer]), _build.ptr(tab), _build.ptr(lens),
        _build.ptr(out), _build.ptr(ids), B, Hkv, G, NP, page, NB,
        block_pages, K, int(kv_pages.dtype == torch.bfloat16),
        int(k_max.dtype == torch.bfloat16), int(group_agg == "sum"),
        int(qk.dtype == torch.bfloat16), sm_scale, _build.stream_of(q))
    _build.check(lib, code, "fused_decode")
    fused_sparse_decode.launches += 1
    return (out, ids) if return_ids else out


fused_sparse_decode.launches = 0
