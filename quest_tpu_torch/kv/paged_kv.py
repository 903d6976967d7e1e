"""Paged KV cache with per-page min/max Key metadata (counterpart of
``quest_tpu/kv/paged_kv.py``).

Layouts are the JAX package's:
  * ``kv_pages [L, Hkv, NP, 2, page, D]`` — one shared physical pool;
    axis -3 is 0=K, 1=V, so a page's K and V are one contiguous block;
  * ``k_max / k_min [L, Hkv, NPB, bpp, D]`` — metadata keyed by PHYSICAL
    page, blocked like the pool (NPB * bpp == NP);
  * ``block_tab [B, NB]`` — physical block of each logical block of a
    slot: physical page of logical page p is
    ``block_tab[b, p // bpp] * bpp + p % bpp``. Physical block 0 is
    scratch: masked writes (inactive decode rows, empty prefill rows)
    land there and never touch another sequence's pages;
  * ``seq_lens [B]`` — tokens stored per slot.

A model with window layers (``SparseWindowConfig.layer_types``) keeps
two such caches: the full layers' (``kv_pages`` etc., indexed in the
full layers' order) and, in ``window``, the window layers', with a pool
and block table of its own and the same ``seq_lens`` tensor. A window layer reads
only a slot's last ``sliding_window`` keys, so its table needs only the
blocks that hold them: the scheduler maps a window block as a slot
reaches it and returns it to its own pool once the slot's window has
passed it (``engine/scheduler.py``); unmapped entries are scratch.

Unlike JAX, which rebuilt the arrays functionally (in place only under
buffer donation), the port updates the cache IN PLACE: every append
writes the touched pool rows and metadata rows of the existing tensors
and returns nothing.

Invariant: the pool never holds a non-finite value. A masked lane
contributes ``0 x V`` to attention and ``0 x NaN = NaN``, so every
append routes K/V through :func:`_finite` (non-finite -> 0); the pool
starts zeroed.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from quest_tpu_torch.config import ModelConfig, QuestConfig
from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.rope import rotate_plain
from quest_tpu_torch.ops.utils import (check_pool_dtype, fp8_cast_codes,
                                       resolve_device)

K, V = 0, 1      # kv_pages axis -3


def _finite(x: torch.Tensor) -> torch.Tensor:
    """Zero out non-finite lanes (see module invariant)."""
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


@dataclasses.dataclass
class LayerKV:
    """Per-slot view of one layer (tests and oracles, not serving), the
    state of :func:`append_decode` and :func:`append_prefill`."""

    kv_pages: torch.Tensor  # [B, Hkv, P, 2, page, D]
    k_max: torch.Tensor     # [B, Hkv, P, D]
    k_min: torch.Tensor     # [B, Hkv, P, D]
    seq_lens: torch.Tensor  # [B]


@dataclasses.dataclass
class PagedKVCache:
    """Whole-model paged KV state, mutated in place by the appends."""

    kv_pages: torch.Tensor   # [L, Hkv, NP, 2, page, D]
    k_max: torch.Tensor      # [L, Hkv, NPB, bpp, D]
    k_min: torch.Tensor      # [L, Hkv, NPB, bpp, D]
    block_tab: torch.Tensor  # [B, NB] int32
    seq_lens: torch.Tensor   # [B] int32
    # The window layers' cache (its seq_lens is this one's), or None: an
    # attribute, not a field, so the fields stay the JAX cache's.
    window = None

    @property
    def page_size(self) -> int:
        return self.kv_pages.shape[-2]

    @property
    def max_pages(self) -> int:
        """Logical pages per slot."""
        return self.block_tab.shape[1] * self.block_pages

    @property
    def block_pages(self) -> int:
        return self.k_max.shape[3]

    @property
    def batch_size(self) -> int:
        return self.block_tab.shape[0]

    def layer(self, l: int) -> LayerKV:
        """Materialized per-slot view [B, Hkv, P, ...] of one layer
        (gathers through the block table — a copy)."""
        bpp = self.block_pages
        B = self.batch_size
        dev = self.kv_pages.device
        phys = (self.block_tab.long()[:, :, None] * bpp
                + torch.arange(bpp, device=dev)[None, None, :]).reshape(B, -1)
        kv = self.kv_pages[l][:, phys]                 # [Hkv, B, P, 2, page, D]
        Hkv, D = self.k_max.shape[1], self.k_max.shape[-1]
        tab = self.block_tab.long()
        kmax = self.k_max[l][:, tab].reshape(Hkv, B, -1, D)
        kmin = self.k_min[l][:, tab].reshape(Hkv, B, -1, D)
        return LayerKV(kv.transpose(0, 1), kmax.transpose(0, 1),
                       kmin.transpose(0, 1), self.seq_lens)

    def rows(self, idx: torch.Tensor) -> "PagedKVCache":
        """The cache of slots ``idx`` (int64, on the cache's device), in
        that order: the same pool and metadata tensors, so appends through
        it write this cache's pages, and copies of those slots' table rows
        and lengths. A step through it advances the copies only; the
        caller writes them back (``seq_lens.index_copy_``). The window
        layers' cache, where there is one, is viewed the same way over the
        view's lengths."""
        view = PagedKVCache(self.kv_pages, self.k_max, self.k_min,
                            self.block_tab.index_select(0, idx),
                            self.seq_lens.index_select(0, idx))
        w = self.window
        if w is not None:
            view.window = PagedKVCache(w.kv_pages, w.k_max, w.k_min,
                                       w.block_tab.index_select(0, idx),
                                       view.seq_lens)
        return view


def init_cache(model: ModelConfig, quest: QuestConfig, batch_size: int = 1,
               num_layers: int | None = None,
               total_pages: int | None = None,
               device="cuda", dp: int = 1,
               window_pages: int | None = None) -> PagedKVCache:
    """Allocate the zeroed pool up front on ``device``.

    A model with window layers gets the full layers' cache with the
    window layers' in its ``window`` (module docstring), whose pool has
    ``window_pages`` pages (default: the same layout as the full
    layers', every slot's table mapped).

    ``total_pages``: physical pool size (default: one scratch block plus
    ``batch_size * max_pages``). The default block table gives slot b
    the contiguous block range ``[1 + b*NB, 1 + (b+1)*NB)``; rows that do
    not fit start out on scratch.

    ``dp``: data-parallel pool replicas (``quest_tpu/kv/paged_kv.py:
    init_cache``'s layout). The physical page axis is cut into ``dp``
    shards, one a dp group (``parallel/mesh.py:cache_specs``), so
    block-table VALUES are shard-local: slot b maps to local slot
    ``b % (B / dp)``'s range, and ``total_pages`` counts pages PER
    SHARD.
    """
    dev = resolve_device(device)
    if model.window_layers and num_layers is None:
        cache = init_cache(model, quest, batch_size,
                           len(model.full_layers), total_pages, dev, dp)
        win = init_cache(model, quest, batch_size, len(model.window_layers),
                         window_pages if window_pages is not None
                         else total_pages, dev, dp)
        win.seq_lens = cache.seq_lens
        cache.window = win
        return cache
    L = num_layers if num_layers is not None else model.num_layers
    B, H, D = batch_size, model.num_kv_heads, model.head_dim
    P, page = quest.max_pages, quest.page_size
    bpp = min(quest.block_pages, P)
    assert P % bpp == 0
    NB = P // bpp
    assert B % dp == 0, (B, dp)
    Bl = B // dp
    if total_pages is None:
        total_pages = bpp + Bl * P       # scratch block + full reservation
    NP = -(-total_pages // bpp) * bpp    # pages a shard
    rows = (torch.arange(B, dtype=torch.int32, device=dev) % Bl)[:, None]
    row_fits = (rows + 1) * NB + 1 <= NP // bpp
    btab = torch.where(row_fits,
                       1 + rows * NB + torch.arange(NB, dtype=torch.int32,
                                                    device=dev),
                       torch.zeros((), dtype=torch.int32, device=dev))
    mdt = quest.resolved_meta_dtype
    return PagedKVCache(
        kv_pages=torch.zeros((L, H, dp * NP, 2, page, D),
                             dtype=quest.kv_dtype, device=dev),
        k_max=torch.zeros((L, H, dp * NP // bpp, bpp, D), dtype=mdt,
                          device=dev),
        k_min=torch.zeros((L, H, dp * NP // bpp, bpp, D), dtype=mdt,
                          device=dev),
        block_tab=btab,
        seq_lens=torch.zeros((B,), dtype=torch.int32, device=dev),
    )


def append_decode(layer: LayerKV, k_new: torch.Tensor,
                  v_new: torch.Tensor) -> LayerKV:
    """Per-slot oracle of :func:`append_decode_at` (``quest_tpu/kv/
    paged_kv.py:append_decode``): write one token per sequence at
    ``seq_lens[b]`` of a :class:`LayerKV` and fold its key into the page's
    min/max (reset at a page's first token). ``k_new, v_new``: [B, Hkv,
    D]. Returns a new ``LayerKV``; ``seq_lens`` does not advance. A page
    index past the view clamps to its last page, as JAX's
    ``dynamic_update_slice`` does."""
    kv, kmax, kmin = (layer.kv_pages.clone(), layer.k_max.clone(),
                      layer.k_min.clone())
    page, P = kv.shape[-2], kv.shape[2]
    kq = _finite(k_new).to(kv.dtype)
    vq = _finite(v_new).to(kv.dtype)
    for b, pos in enumerate(layer.seq_lens.tolist()):
        p, e = min(pos // page, P - 1), pos % page
        kv[b, :, p, K, e] = kq[b]
        kv[b, :, p, V, e] = vq[b]
        kf = kq[b].float()
        if e == 0:
            new_max = new_min = kf
        else:
            new_max = torch.maximum(kmax[b, :, p].float(), kf)
            new_min = torch.minimum(kmin[b, :, p].float(), kf)
        kmax[b, :, p] = new_max.to(kmax.dtype)
        kmin[b, :, p] = new_min.to(kmin.dtype)
    return LayerKV(kv, kmax, kmin, layer.seq_lens)


def append_prefill(layer: LayerKV, k_new: torch.Tensor, v_new: torch.Tensor,
                   new_lens: torch.Tensor | None = None) -> LayerKV:
    """Per-slot oracle of :func:`append_prefill_at` (``quest_tpu/kv/
    paged_kv.py:append_prefill``): write ``T`` tokens per sequence from
    ``seq_lens[b]`` and recompute the min/max of the touched window of
    W = min(P, T // page + 2) pages over the tokens below ``seq_lens[b] +
    new_lens[b]``; pages of the window with none keep their metadata.
    ``k_new, v_new``: [B, T, Hkv, D]; ``new_lens`` defaults to T. The
    window starts at ``min(offset // page, P - W)`` and the write start
    inside it clamps so the T tokens fit, as JAX's
    ``dynamic_update_slice`` does. Returns a new ``LayerKV``."""
    kv, kmax, kmin = (layer.kv_pages.clone(), layer.k_max.clone(),
                      layer.k_min.clone())
    B, T, H, D = k_new.shape
    page, P = kv.shape[-2], kv.shape[2]
    W = min(P, T // page + 2)
    kq = _finite(k_new).to(kv.dtype).transpose(1, 2)        # [B, Hkv, T, D]
    vq = _finite(v_new).to(kv.dtype).transpose(1, 2)
    lens = [T] * B if new_lens is None else new_lens.tolist()
    for b, offset in enumerate(layer.seq_lens.tolist()):
        p0 = min(offset // page, P - W)
        local = min(max(offset - p0 * page, 0), W * page - T)
        win = kv[b, :, p0:p0 + W]                           # [H, W, 2, page, D]
        for kind, new in ((K, kq[b]), (V, vq[b])):
            flat = win[:, :, kind].reshape(H, W * page, D).clone()
            flat[:, local:local + T] = new
            win[:, :, kind] = flat.reshape(H, W, page, D)
        tok_ids = ((p0 + torch.arange(W, device=kv.device))[:, None] * page
                   + torch.arange(page, device=kv.device))
        valid = (tok_ids < offset + lens[b])[None, :, :, None]
        wkf = win[:, :, K].float()                          # [H, W, page, D]
        big = 3.0e38
        any_valid = valid.any(dim=2)                        # [1, W, 1]
        wmax = torch.where(valid, wkf, -big).amax(dim=2)
        wmin = torch.where(valid, wkf, big).amin(dim=2)
        old_max = kmax[b, :, p0:p0 + W].float()
        old_min = kmin[b, :, p0:p0 + W].float()
        kmax[b, :, p0:p0 + W] = torch.where(any_valid, wmax,
                                            old_max).to(kmax.dtype)
        kmin[b, :, p0:p0 + W] = torch.where(any_valid, wmin,
                                            old_min).to(kmin.dtype)
    return LayerKV(kv, kmax, kmin, layer.seq_lens)


def _append_launch_args(cache: PagedKVCache, layer: int, k_new, v_new,
                        active=None, new_lens=None) -> tuple:
    """The checks the appends make on a CUDA tensor (``k_new`` [B, Hkv, D]
    at decode, [B, T, Hkv, D] at prefill), and the arguments their C
    entry points share: the (kv, k_max, k_min, block_tab, seq_lens, mask)
    pointers, the mask ``active`` (decode) or ``new_lens`` (prefill); the
    pool's geometry (NP, page, NPB, bpp, NB); the dtype and e4m3 codes
    (see ``csrc/append.cu``)."""
    kv, kmax, kmin = cache.kv_pages[layer], cache.k_max[layer], cache.k_min[layer]
    B, Hkv, D = k_new.shape[0], k_new.shape[-2], k_new.shape[-1]
    if D != 128:
        raise NotImplementedError("the CUDA kernels take head_dim 128")
    if k_new.dtype not in (torch.bfloat16, torch.float32) or (
            v_new.dtype != k_new.dtype or v_new.shape != k_new.shape):
        raise TypeError(f"k_new / v_new must be one shape and bf16 or f32, "
                        f"got {k_new.dtype} {tuple(k_new.shape)} and "
                        f"{v_new.dtype} {tuple(v_new.shape)}")
    if kv.shape[0] != Hkv or kv.shape[-1] != D:
        raise ValueError(f"k_new {tuple(k_new.shape)} does not fit the pool "
                         f"{tuple(kv.shape)}")
    tab, lens = cache.block_tab, cache.seq_lens
    if tab.dtype != torch.int32 or lens.dtype != torch.int32 or (
            lens.shape != (B,) or tab.shape[0] != B):
        raise TypeError("block_tab [B, NB] and seq_lens [B] must be int32")
    if active is not None and (active.dtype != torch.bool
                               or active.shape != (B,)):
        raise TypeError("active must be a bool [B] tensor")
    if new_lens is not None and (new_lens.dtype != torch.int32
                                 or new_lens.shape != (B,)):
        raise TypeError("new_lens must be an int32 [B] tensor")
    for t in (k_new, v_new, kv, kmax, kmin, tab, lens, active, new_lens):
        if t is not None and (t.device != k_new.device
                              or not t.is_contiguous()):
            raise ValueError("the append takes contiguous operands on "
                             "k_new's device")
    kv_code = check_pool_dtype(kv.dtype)
    meta_code = check_pool_dtype(kmax.dtype, "metadata")
    fp8 = torch.float8_e4m3fn
    pool_codes = (fp8_cast_codes(kv.device, k_new.dtype)
                  if kv.dtype == fp8 else (0, 0))
    meta_codes = (fp8_cast_codes(kv.device, torch.float32)
                  if kmax.dtype == fp8 else (0, 0))
    mask = active if new_lens is None else new_lens
    ptrs = [_build.ptr(t) for t in (kv, kmax, kmin, tab, lens, mask)]
    dims = [kv.shape[1], kv.shape[-2], kmax.shape[1], kmax.shape[2],
            tab.shape[1]]
    codes = [int(k_new.dtype == torch.bfloat16), kv_code, meta_code,
             *pool_codes, *meta_codes]
    return ptrs, dims, codes


def append_decode_at(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor,
                     active: torch.Tensor | None = None) -> None:
    """Write one token per sequence into layer ``layer``, in place.

    ``k_new, v_new``: [B, Hkv, D]; written at ``seq_lens[b]``. Slots with
    ``active=False`` are routed to the scratch block and their metadata
    fold is a no-op. Does not advance ``seq_lens``.

    On a CUDA tensor one launch of ``csrc/append.cu`` (the counterpart of
    the XLA fusion of the JAX ``append_decode_at``), bit for bit
    :func:`append_decode_at_plain`: it reads ``seq_lens``, the block
    table and ``active`` on the device, so a replayed graph sees each
    step's. It takes head dim 128, bf16 or f32 ``k_new`` / ``v_new`` of
    one dtype, contiguous, an int32 table and lengths, a bool ``active``
    and f32 / bf16 / fp8 e4m3 pools and metadata; anything else raises.
    On a CPU tensor :func:`append_decode_at_plain`. The decode step itself
    takes :func:`rope_append_decode_at`, the same launch with the rope.
    """
    if not k_new.is_cuda:
        return append_decode_at_plain(cache, layer, k_new, v_new, active)
    ptrs, dims, codes = _append_launch_args(cache, layer, k_new, v_new,
                                            active)
    B, Hkv, _ = k_new.shape
    lib = _build.load("append")
    code = lib.append_decode_launch(
        *ptrs, _build.ptr(k_new), _build.ptr(v_new), B, Hkv, *dims, *codes,
        _build.stream_of(k_new))
    _build.check(lib, code, "append_decode")
    append_decode_at.launches += 1


append_decode_at.launches = 0


def _rope_append_entry(lib):
    fn = lib.rope_append_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 15 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def rope_append_decode_at(cache: PagedKVCache, layer: int, q: torch.Tensor,
                          k_new: torch.Tensor, v_new: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor,
                          active: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """The decode step's rope and KV append of layer ``layer``, in place:
    returns ``q`` [B, Hq, D] rotated by ``(cos, sin)`` (one pair a row,
    ``rope_cos_sin`` of the step's positions: [B, ..., D/2] f32), and
    appends ``k_new`` [B, Hkv, D], rotated the same way, with ``v_new`` as
    :func:`append_decode_at` does.

    On a CUDA tensor one launch of ``csrc/append.cu`` with its rotate flag
    (the counterpart of the XLA fusions of the JAX ``apply_rope`` of q and
    k and its ``append_decode_at``), bit for bit
    :func:`rope_append_decode_at_plain`. q of k's dtype, Hq a multiple of
    Hkv, every operand contiguous; what :func:`append_decode_at` refuses
    it refuses. On a CPU tensor :func:`rope_append_decode_at_plain`.
    """
    if not q.is_cuda:
        return rope_append_decode_at_plain(cache, layer, q, k_new, v_new,
                                           cos, sin, active)
    B, Hkv, D = k_new.shape
    if q.dtype != k_new.dtype or q.dim() != 3 or q.shape[0] != B or (
            q.shape[2] != D or q.shape[1] % Hkv != 0):
        raise ValueError(f"q {tuple(q.shape)} {q.dtype} does not match k "
                         f"{tuple(k_new.shape)} {k_new.dtype}")
    for t in (cos, sin):
        if t.dtype != torch.float32 or t.numel() != B * D // 2 or (
                t.shape[0] != B or t.shape[-1] != D // 2):
            raise ValueError(f"cos / sin must be f32 [{B}, ..., {D // 2}], "
                             f"got {tuple(t.shape)} {t.dtype}")
    for t in (q, cos, sin):
        if t.device != k_new.device or not t.is_contiguous():
            raise ValueError("the rope and append take contiguous operands "
                             "on k_new's device")
    ptrs, dims, codes = _append_launch_args(cache, layer, k_new, v_new,
                                            active)
    q_out = torch.empty_like(q)
    lib = _build.load("append")
    code = _rope_append_entry(lib)(
        *ptrs, _build.ptr(q), _build.ptr(k_new), _build.ptr(v_new),
        _build.ptr(q_out), _build.ptr(cos), _build.ptr(sin), B, Hkv,
        q.shape[1] // Hkv, *dims, *codes, _build.stream_of(q))
    _build.check(lib, code, "rope_append")
    rope_append_decode_at.launches += 1
    return q_out


rope_append_decode_at.launches = 0


def rope_append_decode_at_plain(cache: PagedKVCache, layer: int,
                                q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, cos: torch.Tensor,
                                sin: torch.Tensor,
                                active: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """:func:`rope_append_decode_at` in plain PyTorch ops: ``rotate_plain``
    of q and of k, then :func:`append_decode_at_plain` of the rotated k
    (the CPU's path, and what the kernel is held to on the card)."""
    B = q.shape[0]
    cs, sn = (t.reshape(B, 1, t.shape[-1]) for t in (cos, sin))
    append_decode_at_plain(cache, layer, rotate_plain(k_new, cs, sn), v_new,
                           active)
    return rotate_plain(q, cs, sn)


def append_decode_at_plain(cache: PagedKVCache, layer: int,
                           k_new: torch.Tensor, v_new: torch.Tensor,
                           active: torch.Tensor | None = None) -> None:
    """:func:`append_decode_at` in plain PyTorch ops (the CPU's path, and
    what the kernel is held to on the card)."""
    kv, kmax, kmin = cache.kv_pages[layer], cache.k_max[layer], cache.k_min[layer]
    page = kv.shape[-2]
    bpp = cache.block_pages
    NB = cache.block_tab.shape[1]
    B = k_new.shape[0]
    kq = _finite(k_new).to(kv.dtype)
    vq = _finite(v_new).to(kv.dtype)
    pos = cache.seq_lens.long()
    p_log = pos // page
    e_idx = pos % page
    tab = cache.block_tab.long()
    if active is not None:
        tab = torch.where(active[:, None], tab, torch.zeros_like(tab))
    row = torch.arange(B, device=kv.device)
    blk = tab[row, (p_log // bpp).clamp(max=NB - 1)]     # [B] phys block
    off = p_log % bpp
    p_phys = blk * bpp + off

    kv[:, p_phys, K, e_idx] = kq.transpose(0, 1)
    kv[:, p_phys, V, e_idx] = vq.transpose(0, 1)

    old_max = kmax[:, blk, off].float()                  # [Hkv, B, D]
    old_min = kmin[:, blk, off].float()
    kf = kq.float().transpose(0, 1)
    first = (e_idx == 0)[None, :, None]
    new_max = torch.where(first, kf, torch.maximum(old_max, kf))
    new_min = torch.where(first, kf, torch.minimum(old_min, kf))
    if active is not None:
        act = active[None, :, None]
        new_max = torch.where(act, new_max, old_max)
        new_min = torch.where(act, new_min, old_min)
    kmax[:, blk, off] = new_max.to(kmax.dtype)
    kmin[:, blk, off] = new_min.to(kmin.dtype)


def _prefill_entry(lib):
    fn = lib.append_prefill_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 17 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _prefill_launch_args(cache: PagedKVCache, layer: int, k_new, v_new,
                         new_lens) -> tuple:
    """The checks the prefill append makes on a CUDA tensor: those of
    :func:`_append_launch_args`, a chunk that fits its window and 16-byte
    aligned operands. Returns its arguments and the window's pages W =
    min(P, T // page + 2)."""
    T = k_new.shape[1]
    W = min(cache.max_pages, T // cache.page_size + 2)
    if T > W * cache.page_size:
        raise ValueError(f"a chunk of {T} tokens does not fit the "
                         f"{W}-page window of {cache.page_size}-token pages")
    ptrs, dims, codes = _append_launch_args(cache, layer, k_new, v_new,
                                            new_lens=new_lens)
    for t in (k_new, v_new, cache.kv_pages[layer], cache.k_max[layer],
              cache.k_min[layer]):
        if t.data_ptr() % 16:
            raise ValueError("the prefill append takes 16-byte aligned k, "
                             "v, pool and metadata")
    return ptrs, dims, codes, W


def append_prefill_at(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                      v_new: torch.Tensor,
                      new_lens: torch.Tensor | None = None) -> None:
    """Write ``T`` tokens per sequence into layer ``layer`` starting at
    ``seq_lens[b]``, in place, and recompute the min/max metadata of the
    touched page window.

    ``k_new, v_new``: [B, T, Hkv, D]; ``new_lens`` [B] real tokens per
    row (default T). Rows with ``new_lens == 0`` are routed to scratch
    and skip metadata. The window of W = min(P, T // page + 2) pages
    starts at ``p0 = min(offset // page, P - W)``, and the write start
    inside it is clamped so the T tokens fit, as JAX's
    ``dynamic_update_slice`` clamps.

    On a CUDA tensor one launch of ``csrc/append.cu``'s prefill route (the
    counterpart of the XLA fusion of the JAX ``append_prefill_at``), bit
    for bit :func:`append_prefill_at_plain` outside scratch block 0 (a row
    with ``new_lens == 0`` writes nothing there): it reads ``seq_lens``,
    the block table and ``new_lens`` on the device. It takes what
    :func:`append_decode_at` takes (head dim 128, bf16 or f32 ``k_new`` /
    ``v_new`` of one dtype, contiguous and 16-byte aligned, f32 / bf16 /
    fp8 e4m3 pools and metadata), an int32 ``new_lens`` and T <= W x page;
    anything else raises. On a CPU tensor :func:`append_prefill_at_plain`.
    """
    if not k_new.is_cuda:
        return append_prefill_at_plain(cache, layer, k_new, v_new, new_lens)
    ptrs, dims, codes, W = _prefill_launch_args(cache, layer, k_new, v_new,
                                                new_lens)
    B, T, Hkv, _ = k_new.shape
    lib = _build.load("append")
    code = _prefill_entry(lib)(
        *ptrs, _build.ptr(k_new), _build.ptr(v_new), B, T, Hkv, *dims,
        cache.max_pages, W, *codes, _build.stream_of(k_new))
    _build.check(lib, code, "append_prefill")
    append_prefill_at.launches += 1


append_prefill_at.launches = 0


def append_prefill_at_plain(cache: PagedKVCache, layer: int,
                            k_new: torch.Tensor, v_new: torch.Tensor,
                            new_lens: torch.Tensor | None = None) -> None:
    """:func:`append_prefill_at` in plain PyTorch ops (the CPU's path, and
    what the kernel is held to on the card)."""
    kv, kmax, kmin = cache.kv_pages[layer], cache.k_max[layer], cache.k_min[layer]
    B, T, H, D = k_new.shape
    page = kv.shape[-2]
    P = cache.max_pages
    bpp = cache.block_pages
    dev = kv.device
    if new_lens is None:
        new_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    new_lens = new_lens.long()
    W = min(P, T // page + 2)
    active = new_lens > 0
    tab = cache.block_tab.long()
    tab = torch.where(active[:, None], tab, torch.zeros_like(tab))
    row = torch.arange(B, device=dev)

    offset = cache.seq_lens.long()
    p0 = torch.clamp(offset // page, max=P - W)
    local = (offset - p0 * page).clamp(0, W * page - T)     # DUS clamp
    tok = p0[:, None] * page + local[:, None] + torch.arange(T, device=dev)
    t_page = tok // page                                     # [B, T] logical
    t_phys = tab[row[:, None], t_page // bpp] * bpp + t_page % bpp
    t_ent = tok % page
    kv[:, t_phys, K, t_ent] = _finite(k_new).to(kv.dtype).permute(2, 0, 1, 3)
    kv[:, t_phys, V, t_ent] = _finite(v_new).to(kv.dtype).permute(2, 0, 1, 3)

    # Recompute min/max over the touched window, keyed by the physical
    # (block, page) the data write targeted.
    wpages = p0[:, None] + torch.arange(W, device=dev)[None, :]   # [B, W]
    wblk = tab[row[:, None], wpages // bpp]                       # [B, W]
    woff = wpages % bpp
    wkf = kv[:, wblk * bpp + woff, K].float()          # [Hkv, B, W, page, D]
    tok_ids = wpages[:, :, None] * page + torch.arange(page, device=dev)
    valid = (tok_ids < (offset + new_lens)[:, None, None])[None, ..., None]
    big = 3.0e38
    wmax = torch.where(valid, wkf, -big).amax(dim=3)    # [Hkv, B, W, D]
    wmin = torch.where(valid, wkf, big).amin(dim=3)
    write = valid.any(dim=3) & active[None, :, None, None]
    old_max = kmax[:, wblk, woff].float()
    old_min = kmin[:, wblk, woff].float()
    kmax[:, wblk, woff] = torch.where(write, wmax, old_max).to(kmax.dtype)
    kmin[:, wblk, woff] = torch.where(write, wmin, old_min).to(kmin.dtype)
