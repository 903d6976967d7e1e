"""Dense paged flash-decode attention (counterpart of
``quest_tpu/ops/dense_decode.py``).

Used by the first ``skip_layers`` layers of every decode step. On a CUDA
tensor :func:`dense_decode_attention` launches the hand-written kernel
``csrc/dense_decode.cu`` (one launch a call over bf16 and fp8 pools, the
splits merged inside it); on a CPU tensor it runs
:func:`dense_decode_attention_plain`, the same function in eager
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

# Splits (ops/decode_common.py:decode_plan): the block table's capacity of
# the batch's (row, KV head)s spread over CTAS_PER_SM CTAs an SM, none of
# fewer than MIN_SPLIT_TOKENS tokens.
CTAS_PER_SM = 3
MIN_SPLIT_TOKENS = 512


def dense_decode_attention_plain(q, kv_pages, seq_lens, *, sm_scale: float,
                                 layer: int, block_tab, block_pages: int,
                                 window: int = 0):
    """Eager version: gather every logical page of each slot through the
    block table, mask tokens >= seq_len (and, with a window, tokens <
    seq_len - window), one-pass softmax in f32, p
    rounded to the compute dtype (the pool's, bf16 for an fp8 pool) before
    PV; fp8 pages are read through ``upcast_fp8``. q [B, Hq, D] ->
    [B, Hq, D] f32."""
    B, Hq, D = q.shape
    kvl = kv_pages[layer]                            # [Hkv, NP, 2, page, D]
    Hkv, page = kvl.shape[0], kvl.shape[-2]
    G = Hq // Hkv
    bpp = block_pages
    P = block_tab.shape[1] * bpp
    dev = q.device
    qs = scaled_query(q, sm_scale, kvl.dtype).float().reshape(B, Hkv, G, D)
    lp = torch.arange(P, device=dev)
    phys = block_tab.long()[:, lp // bpp] * bpp + lp % bpp     # [B, P]
    sel = kvl[:, phys]                               # [Hkv, B, P, 2, page, D]
    k = sel[:, :, :, 0].reshape(Hkv, B, P * page, D).transpose(0, 1)
    v = sel[:, :, :, 1].reshape(Hkv, B, P * page, D).transpose(0, 1)
    s = torch.einsum("bkgd,bktd->bkgt", qs, to_f32(k))
    tok = torch.arange(P * page, device=dev)[None, :]
    valid = tok < seq_lens.long()[:, None]
    if window:
        valid &= tok >= seq_lens.long()[:, None] - window
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, MASK_VALUE))
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                    torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgt,bktd->bkgd", p.to(compute_dtype(v.dtype)).float(),
                     to_f32(v))
    o = torch.where(l > 0, o / l, torch.zeros_like(o))
    return o.reshape(B, Hq, D)


def dense_decode_attention(q, kv_pages, seq_lens, *, sm_scale: float,
                           layer: int, block_tab, block_pages: int,
                           window: int = 0):
    """Decode attention over every cached token of each slot, or with
    ``window > 0`` over its last ``window`` tokens (a window layer: the
    table's pages below the window are never read, so they may be
    unmapped).

    q: [B, Hq, D] un-scaled query; kv_pages: the whole-model shared pool
    [L, Hkv, NP, 2, page, D] (f32, bf16 or fp8 e4m3), read at ``layer``;
    seq_lens: [B] tokens per slot including the current one; block_tab
    [B, NB] int32; block_pages: pages per allocation block.
    Returns [B, Hq, D] f32.
    """
    kv_code = check_pool_dtype(kv_pages.dtype)
    if not q.is_cuda:
        return dense_decode_attention_plain(
            q, kv_pages, seq_lens, sm_scale=sm_scale, layer=layer,
            block_tab=block_tab, block_pages=block_pages, window=window)
    B, Hq, D = q.shape
    _, Hkv, NP, _, page, Dk = kv_pages.shape
    G = Hq // Hkv
    if D != 128 or Dk != 128:
        raise NotImplementedError("the CUDA decode kernels take head_dim 128")
    if G < 1 or G * Hkv != Hq:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV "
                         "heads")
    for t in (kv_pages, block_tab, seq_lens):
        if t.device != q.device:
            raise ValueError("all operands must be on the query's device")
    if not kv_pages.is_contiguous():
        raise ValueError("kv_pages must be contiguous")
    NB = block_tab.shape[1]
    # Sized from the table's capacity (a window's pages: the first may be
    # partial), not from seq_lens (no host read).
    items = NB * block_pages
    if window:
        items = min(items, -(-window // page) + 1)
    plan = decode_plan(B, Hkv, G, page, items, MIN_SPLIT_TOKENS,
                       CTAS_PER_SM * sm_count(q.device))
    qk = kernel_query(q)
    tab = block_tab.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    part_o, part_ml, tickets = workspace(q.device, plan)
    out = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    lib = _build.load("dense_decode")
    kvl = kv_pages[layer]
    tmap = tensor_map(lib, kvl) if kvl.dtype == torch.bfloat16 else None
    code = lib.dense_decode_launch(
        _build.ptr(qk), _build.ptr(kvl), _build.ptr(tab),
        _build.ptr(lens), _build.ptr(part_o), _build.ptr(part_ml),
        _build.ptr(tickets), _build.ptr(out), B, Hkv, G, NP, page, NB,
        block_pages, plan.nsplit, plan.per_split, kv_code, sm_scale,
        int(qk.dtype == torch.bfloat16), int(window), tmap,
        _build.stream_of(q))
    _build.check(lib, code, "dense_decode")
    dense_decode_attention.launches += 1
    return out


dense_decode_attention.launches = 0
