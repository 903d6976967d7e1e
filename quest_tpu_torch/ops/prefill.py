"""Causal paged flash-prefill attention (counterpart of
``quest_tpu/ops/prefill.py``).

On a CUDA tensor :func:`prefill_attention` launches the hand-written
kernel ``csrc/prefill.cu`` (TMA page loads and wgmma for bf16 and fp8
e4m3 pools, FMA for f32 pools and for pages the TMA kernel does not
take; :func:`prefill_route`); on a CPU tensor it runs
:func:`prefill_attention_plain`, the same function in eager PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.utils import (MASK_VALUE, check_pool_dtype,
                                      compute_dtype, kernel_query,
                                      scaled_query, to_f32)


def prefill_attention_plain(q, kv_pages, q_offsets, kv_lens, *,
                            sm_scale: float, layer: int, block_tab,
                            block_pages: int, window: int = 0):
    """Eager version: every logical token of the slot through the block
    table, causal and length mask (and with a window, keys above the
    query's position less ``window``), one-pass softmax in f32, p rounded to
    the compute dtype (the pool's, bf16 for an fp8 pool) before PV, fp8
    pages read through ``upcast_fp8``; one KV head at a time to bound
    memory.
    A row with no key at all (kv_len == 0) gives zeros."""
    B, T, Hq, D = q.shape
    kvl = kv_pages[layer]                            # [Hkv, NP, 2, page, D]
    Hkv, page = kvl.shape[0], kvl.shape[-2]
    G = Hq // Hkv
    bpp = block_pages
    P = block_tab.shape[1] * bpp
    dev = q.device
    qs = scaled_query(q, sm_scale, kvl.dtype).float()         # [B,T,Hq,D]
    lp = torch.arange(P, device=dev)
    phys = block_tab.long()[:, lp // bpp] * bpp + lp % bpp     # [B, P]
    q_pos = q_offsets.long()[:, None] + torch.arange(T, device=dev)[None, :]
    tok = torch.arange(P * page, device=dev)
    valid = ((tok[None, None, :] <= q_pos[:, :, None])
             & (tok[None, None, :] < kv_lens.long()[:, None, None]))
    if window:
        valid &= tok[None, None, :] > q_pos[:, :, None] - window
    valid = valid[:, None]                                     # [B,1,T,Tkv]
    out = torch.empty((B, T, Hq, D), dtype=torch.float32, device=dev)
    for h in range(Hkv):
        sel = kvl[h][phys]                           # [B, P, 2, page, D]
        k = sel[:, :, 0].reshape(B, P * page, D)
        v = sel[:, :, 1].reshape(B, P * page, D)
        qh = qs[:, :, h * G:(h + 1) * G].permute(0, 2, 1, 3)   # [B,G,T,D]
        s = torch.einsum("bgqd,btd->bgqt", qh, to_f32(k))
        s = torch.where(valid, s, torch.full_like(s, MASK_VALUE))
        p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                        torch.zeros_like(s))
        l = p.sum(dim=-1, keepdim=True)
        o = torch.einsum("bgqt,btd->bgqd",
                         p.to(compute_dtype(v.dtype)).float(), to_f32(v))
        o = torch.where(l > 0, o / l, torch.zeros_like(o))
        out[:, :, h * G:(h + 1) * G] = o.permute(0, 2, 1, 3)
    return out


# What the TMA + wgmma kernel (bf16 and fp8 pools) takes: 128 query rows
# a CTA are positions x the heads of a GQA group padded to the next of 1,
# 2, 4, 8 and 16 (sub-groups of 16 above that; ops/utils.py:
# padded_group), and a 128-token K/V tile is whole pages of at least 8
# rows (1024 bytes: one 128-byte swizzle atom).
TMA_PAGES = (8, 16, 32, 64, 128)
_tensor_maps = {}


def prefill_route(dtype: torch.dtype, page: int, G: int) -> str:
    """The card kernel of a pool of ``dtype`` with pages of ``page`` tokens
    and GQA groups of G query heads: ``"tma"`` (TMA + wgmma, bf16 and fp8
    pools with pages in TMA_PAGES) or ``"fma"`` (f32 pools, and bf16 or
    fp8 pools with other pages). Both take every G."""
    code = check_pool_dtype(dtype)
    if G < 1:
        raise ValueError(f"a GQA group of {G} query heads")
    return "tma" if code != 0 and page in TMA_PAGES else "fma"


def _tensor_map(lib, kvl, kv_code):
    """The TMA descriptor of one layer of the pool, seen as rows of 128
    elements ``[Hkv * NP * 2 * page, 128]``, cached by (pointer, shape,
    dtype); the address of its 128 bytes. A failed encode raises."""
    key = (kvl.data_ptr(), tuple(kvl.shape), kvl.dtype)
    buf = _tensor_maps.get(key)
    if buf is None:
        fn = lib.prefill_tensor_map
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        buf = ctypes.create_string_buffer(128)
        code = fn(_build.ptr(kvl), kvl.numel() // kvl.shape[-1], kv_code,
                  kvl.shape[-2], ctypes.addressof(buf))
        if code != 0:
            raise RuntimeError(f"cuTensorMapEncodeTiled failed for the "
                               f"prefill pool (CUresult {code})")
        _tensor_maps[key] = buf
    return ctypes.addressof(buf)


def prefill_attention(q, kv_pages, q_offsets, kv_lens, *, sm_scale: float,
                      layer: int, block_tab, block_pages: int,
                      window: int = 0):
    """Causal attention of T fresh queries over the paged cache; with
    ``window > 0`` the query at position p sees only the keys p - window +
    1 .. p (a window layer: pages below every query's window are not
    read, so they may be unmapped).

    q: [B, T, Hq, D] (rope applied, un-scaled); kv_pages: the shared
    pool [L, Hkv, NP, 2, page, D] with the new tokens already appended,
    read at ``layer``; q_offsets: [B] tokens cached before this chunk;
    kv_lens: [B] = q_offsets + real new length; block_tab [B, NB].
    Returns [B, T, Hq, D] f32.
    """
    kv_code = check_pool_dtype(kv_pages.dtype)
    if not q.is_cuda:
        return prefill_attention_plain(
            q, kv_pages, q_offsets, kv_lens, sm_scale=sm_scale, layer=layer,
            block_tab=block_tab, block_pages=block_pages, window=window)
    B, T, Hq, D = q.shape
    _, Hkv, NP, _, page, Dk = kv_pages.shape
    if D != 128 or Dk != 128:
        raise NotImplementedError("the CUDA prefill kernel takes head_dim 128")
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV heads")
    route = prefill_route(kv_pages.dtype, page, Hq // Hkv)
    for t in (kv_pages, q_offsets, kv_lens, block_tab):
        if t.device != q.device:
            raise ValueError("all operands must be on the query's device")
    if not kv_pages.is_contiguous():
        raise ValueError("kv_pages must be contiguous")
    qk = kernel_query(q)
    tab = block_tab.to(torch.int32).contiguous()
    offs = q_offsets.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    out = torch.empty((B, T, Hq, D), dtype=torch.float32, device=q.device)
    lib = _build.load("prefill")
    kvl = kv_pages[layer]
    tmap = _tensor_map(lib, kvl, kv_code) if route == "tma" else None
    code = lib.prefill_launch(
        _build.ptr(qk), _build.ptr(kvl), _build.ptr(tab),
        _build.ptr(offs), _build.ptr(lens), _build.ptr(out), B, T, Hq, Hkv,
        NP, page, tab.shape[1], block_pages,
        kv_code, int(route == "fma"), sm_scale,
        int(qk.dtype == torch.bfloat16), int(window), tmap,
        _build.stream_of(q))
    _build.check(lib, code, "prefill")
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0
