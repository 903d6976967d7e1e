"""Sparse paged flash-decode attention over the selected pages — the
signature Quest kernel (counterpart of ``quest_tpu/ops/sparse_decode.py``).

On a CUDA tensor :func:`sparse_decode_attention` launches the
hand-written kernel ``csrc/sparse_decode.cu`` (one launch a call over
bf16 and fp8 pools, the splits merged inside it); on a CPU tensor it runs
:func:`sparse_decode_attention_plain`, the same function in eager
PyTorch.
"""

from __future__ import annotations

import torch

from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.decode_common import (decode_plan, sm_count,
                                               tensor_map, workspace)
from quest_tpu_torch.ops.utils import (MASK_VALUE, check_pool_dtype,
                                      compute_dtype, kernel_query,
                                      scaled_query, to_f32)

# Splits (ops/decode_common.py:decode_plan): the selection slots of the
# batch's (row, selection head)s spread over CTAS_PER_SM CTAs an SM, none
# of fewer than MIN_SPLIT_TOKENS tokens.
CTAS_PER_SM = 1
MIN_SPLIT_TOKENS = 128


def _selection_shape(q, kv_pages, indices, per_q_head: bool):
    """(Hsel, G, kvdiv): selection heads, query heads per selection
    head, and query heads per KV head read by a selection head."""
    Hq, Hkv = q.shape[1], kv_pages.shape[1]
    if per_q_head:
        Hsel, G, kvdiv = Hq, 1, Hq // Hkv
    else:
        Hsel, G, kvdiv = Hkv, Hq // Hkv, 1
    if indices.shape[1] != Hsel:
        raise ValueError(f"indices have {indices.shape[1]} heads, expected "
                         f"{Hsel}")
    return Hsel, G, kvdiv


def sparse_decode_attention_plain(q, kv_pages, indices, num_valid, seq_lens,
                                  *, sm_scale: float, layer: int, block_tab,
                                  block_pages: int, per_q_head: bool = False):
    """Eager version: gather the selected logical pages through the block
    table, mask slots >= num_valid and tokens >= seq_len, one-pass
    softmax in f32, p rounded to the compute dtype (the pool's, bf16 for
    an fp8 pool) before PV; fp8 pages are read through ``upcast_fp8``."""
    B, Hq, D = q.shape
    kvl = kv_pages[layer]                            # [Hkv, NP, 2, page, D]
    page = kvl.shape[-2]
    Hsel, G, kvdiv = _selection_shape(q, kv_pages, indices, per_q_head)
    S = indices.shape[-1]
    bpp = block_pages
    dev = q.device
    qs = scaled_query(q, sm_scale, kvl.dtype).float().reshape(B, Hsel, G, D)
    ids = indices.long()                                        # [B, Hsel, S]
    blk = torch.gather(block_tab.long(), 1, (ids // bpp).reshape(B, -1))
    phys = blk.reshape(B, Hsel, S) * bpp + ids % bpp
    hk = (torch.arange(Hsel, device=dev) // kvdiv)[None, :, None]
    sel = kvl[hk, phys]                              # [B, Hsel, S, 2, page, D]
    k = sel[:, :, :, 0].reshape(B, Hsel, S * page, D)
    v = sel[:, :, :, 1].reshape(B, Hsel, S * page, D)
    s = torch.einsum("bhgd,bhtd->bhgt", qs, to_f32(k))
    slot = torch.arange(S, device=dev)[None, None, :, None]
    entry = torch.arange(page, device=dev)[None, None, None, :]
    valid = ((slot < num_valid.long()[:, None, None, None])
             & (ids[..., None] * page + entry
                < seq_lens.long()[:, None, None, None]))
    valid = valid.reshape(B, Hsel, 1, S * page)
    s = torch.where(valid, s, torch.full_like(s, MASK_VALUE))
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                    torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgt,bhtd->bhgd", p.to(compute_dtype(v.dtype)).float(),
                     to_f32(v))
    o = torch.where(l > 0, o / l, torch.zeros_like(o))
    return o.reshape(B, Hq, D)


def sparse_decode_attention(q, kv_pages, indices, num_valid, seq_lens, *,
                            sm_scale: float, layer: int, block_tab,
                            block_pages: int, per_q_head: bool = False):
    """Decode attention over the selected pages.

    q: [B, Hq, D] un-scaled query; kv_pages: the whole-model shared pool
    [L, Hkv, NP, 2, page, D] (f32, bf16 or fp8 e4m3) read at ``layer``;
    indices:
    [B, Hkv, S] int32 selected LOGICAL page ids ([B, Hq, S] when
    ``per_q_head``), valid slots distinct, slots >= num_valid junk but
    in range (``select_pages`` guarantees both); num_valid: [B];
    seq_lens: [B] including the current token; block_tab [B, NB].
    Returns [B, Hq, D] f32.
    """
    kv_code = check_pool_dtype(kv_pages.dtype)
    if not q.is_cuda:
        return sparse_decode_attention_plain(
            q, kv_pages, indices, num_valid, seq_lens, sm_scale=sm_scale,
            layer=layer, block_tab=block_tab, block_pages=block_pages,
            per_q_head=per_q_head)
    B, Hq, D = q.shape
    _, Hkv, NP, _, page, Dk = kv_pages.shape
    Hsel, G, kvdiv = _selection_shape(q, kv_pages, indices, per_q_head)
    if D != 128 or Dk != 128:
        raise NotImplementedError("the CUDA decode kernels take head_dim 128")
    if Hsel * G != Hq or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV "
                         "heads")
    for t in (kv_pages, indices, num_valid, block_tab, seq_lens):
        if t.device != q.device:
            raise ValueError("all operands must be on the query's device")
    if not kv_pages.is_contiguous():
        raise ValueError("kv_pages must be contiguous")
    S = indices.shape[-1]
    NB = block_tab.shape[1]
    plan = decode_plan(B, Hsel, G, page, S, MIN_SPLIT_TOKENS,
                       CTAS_PER_SM * sm_count(q.device))
    qk = kernel_query(q)
    idx = indices.to(torch.int32).contiguous()
    nv = num_valid.to(torch.int32).contiguous()
    tab = block_tab.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    part_o, part_ml, tickets = workspace(q.device, plan)
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    lib = _build.load("sparse_decode")
    kvl = kv_pages[layer]
    tmap = tensor_map(lib, kvl) if kvl.dtype == torch.bfloat16 else None
    code = lib.sparse_decode_launch(
        _build.ptr(qk), _build.ptr(kvl), _build.ptr(tab),
        _build.ptr(lens), _build.ptr(idx), _build.ptr(nv),
        _build.ptr(part_o), _build.ptr(part_ml), _build.ptr(tickets),
        _build.ptr(out), B, Hsel, G, kvdiv, NP, page, NB, block_pages, S,
        plan.nsplit, plan.per_split, kv_code, sm_scale,
        int(qk.dtype == torch.bfloat16), tmap, _build.stream_of(q))
    _build.check(lib, code, "sparse_decode")
    sparse_decode_attention.launches += 1
    return out


sparse_decode_attention.launches = 0
