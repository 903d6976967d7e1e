"""Query-aware page criticality estimation (counterpart of
``quest_tpu/ops/estimate.py``).

For every page p and head h the upper bound on the page's pre-softmax
score is ``sum_d max(q_d * maxK_d, q_d * minK_d)``, which splits by the
sign of q into ``relu(q) @ maxK^T + min(q, 0) @ minK^T``: two plain
matrix products, as XLA ran them in the JAX package. GQA scores are
combined over the group (max or sum) so selection is per KV head.

The products are f32 at full precision as long as CUDA matrix products
do not use TF32 (``torch.backends.cuda.matmul.allow_tf32``, False by
default); ``QuestModel`` switches it off once when it is built on the
card.

:func:`page_scores_kernel` is the streaming estimate (the JAX package's
Pallas ``page_scores_kernel``): on a CUDA tensor it launches
``csrc/estimate.cu``, whose scoring code the fused decode kernel shares;
on a CPU tensor it runs :func:`page_scores_kernel_plain`.
:func:`page_scores_physical`, the unfused decode step's estimate, launches
the same source's physical route on a CUDA tensor (the counterpart of the
XLA fusion the JAX package runs there) and
:func:`page_scores_physical_plain` on a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.utils import (check_kernel_operands,
                                      check_pool_dtype, compute_dtype,
                                      kernel_query, to_f32)


def _group_scores(q: torch.Tensor, k_max: torch.Tensor,
                  k_min: torch.Tensor) -> torch.Tensor:
    """[B, Hq, D] x 2x[B, Hkv, P, D] -> [B, Hkv, G, P] f32."""
    B, Hq, D = q.shape
    Hkv = k_max.shape[1]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, D)
    return (torch.einsum("bkgd,bkpd->bkgp", qf.clamp(min=0.0), k_max.float())
            + torch.einsum("bkgd,bkpd->bkgp", qf.clamp(max=0.0),
                           k_min.float()))


def _aggregate(s: torch.Tensor, group_agg: str) -> torch.Tensor:
    if group_agg == "max":
        return s.amax(dim=2)
    if group_agg == "sum":
        return s.sum(dim=2)
    raise ValueError(f"unknown group_agg {group_agg!r}")


def page_scores(q: torch.Tensor, k_max: torch.Tensor, k_min: torch.Tensor,
                group_agg: str = "max") -> torch.Tensor:
    """Criticality scores per KV head over logical ``[B, Hkv, P, D]``
    metadata; q is un-scaled. Returns [B, Hkv, P] f32."""
    return _aggregate(_group_scores(q, k_max, k_min), group_agg)


def page_scores_per_qhead(q: torch.Tensor, k_max: torch.Tensor,
                          k_min: torch.Tensor) -> torch.Tensor:
    """Un-aggregated scores [B, Hq, P]."""
    B, Hq, _ = q.shape
    return _group_scores(q, k_max, k_min).reshape(B, Hq, -1)


def page_scores_physical_plain(q: torch.Tensor, k_max_l: torch.Tensor,
                               k_min_l: torch.Tensor, block_tab: torch.Tensor,
                               group_agg: str = "max",
                               per_q_head: bool = False) -> torch.Tensor:
    """Eager version of :func:`page_scores_physical`, as the JAX package
    computes it: scores every physical page once for the whole batch
    (metadata is keyed by physical page, kv/paged_kv.py) with f32 q and
    metadata widened by the plain cast (fp8 denormals kept), then
    gathers each slot's logical scores through its block table with an
    exact index gather (the JAX package used a one-hot contraction, a TPU
    workaround)."""
    Hkv, NPB, bpp, D = k_max_l.shape
    B, Hq, _ = q.shape
    km = k_max_l.reshape(Hkv, NPB * bpp, D).float()
    kn = k_min_l.reshape(Hkv, NPB * bpp, D).float()
    qf = q.float().reshape(B, Hkv, Hq // Hkv, D)
    s = (torch.einsum("bkgd,kpd->bkgp", qf.clamp(min=0.0), km)
         + torch.einsum("bkgd,kpd->bkgp", qf.clamp(max=0.0), kn))
    s = s.reshape(B, Hq, -1) if per_q_head else _aggregate(s, group_agg)
    H = s.shape[1]
    NB = block_tab.shape[1]
    idx = block_tab.long()[:, None, :, None].expand(B, H, NB, bpp)
    return torch.gather(s.reshape(B, H, NPB, bpp), 2, idx).reshape(
        B, H, NB * bpp)


PLAN_KEYS = ("bulk", "stage_pages", "stages", "units", "grid",
             "smem_bytes", "ctas_per_sm")


def _physical_entry(lib):
    fn = lib.estimate_physical_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def physical_plan(k_max_l: torch.Tensor, B: int, NB: int, G: int) -> dict:
    """The launch plan that :func:`page_scores_physical` takes on the
    current card for metadata ``k_max_l`` [Hkv, NPB, bpp, D], a [B, NB]
    block table and groups of ``G`` query rows, as ``csrc/estimate.cu``'s
    launcher works it out (``phys_plan``): {key of :data:`PLAN_KEYS`:
    int}. Needs the card."""
    Hkv, _, bpp, _ = k_max_l.shape
    lib = _build.load("estimate")
    fn = lib.estimate_physical_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    plan = (ctypes.c_int64 * len(PLAN_KEYS))()
    code = fn(B, Hkv, G, bpp, NB,
              check_pool_dtype(k_max_l.dtype, "page metadata"), plan)
    _build.check(lib, code, "estimate (physical plan)")
    return dict(zip(PLAN_KEYS, plan))


def page_scores_physical(q: torch.Tensor, k_max_l: torch.Tensor,
                         k_min_l: torch.Tensor, block_tab: torch.Tensor,
                         group_agg: str = "max",
                         per_q_head: bool = False) -> torch.Tensor:
    """Criticality scores over the PHYSICAL pool, per slot: each slot's
    logical pages scored through its block table, q kept in f32.

    q: [B, Hq, D] un-scaled; k_max_l/k_min_l: [Hkv, NPB, bpp, D] (one
    layer, f32, bf16 or fp8 e4m3); block_tab: [B, NB], entries in
    [0, NPB). Returns [B, Hkv, P] f32 ([B, Hq, P] when ``per_q_head``),
    P = NB * bpp. On a CUDA tensor one launch of ``csrc/estimate.cu``'s
    physical route (:func:`physical_plan`); on a CPU tensor
    :func:`page_scores_physical_plain`.
    """
    if group_agg not in ("max", "sum"):
        raise ValueError(f"unknown group_agg {group_agg!r}")
    if not q.is_cuda:
        return page_scores_physical_plain(q, k_max_l, k_min_l, block_tab,
                                          group_agg, per_q_head)
    meta_code = check_pool_dtype(k_max_l.dtype, "page metadata")
    if k_min_l.dtype != k_max_l.dtype or k_min_l.shape != k_max_l.shape:
        raise ValueError("k_max and k_min must share dtype and shape")
    Hkv, NPB, bpp, _ = k_max_l.shape
    G = check_kernel_operands(q, Hkv, k_max_l, k_min_l)
    if G > 128:
        raise NotImplementedError(
            f"the physical estimate takes groups of at most 128 query "
            f"heads, got {G}")
    if block_tab.device != q.device:
        raise ValueError("block_tab must be on the query's device")
    B, Hq, _ = q.shape
    NB = block_tab.shape[1]
    qk = kernel_query(q)
    tab = block_tab.to(torch.int32).contiguous()
    out = torch.empty((B, Hq if per_q_head else Hkv, NB * bpp),
                      dtype=torch.float32, device=q.device)
    lib = _build.load("estimate")
    code = _physical_entry(lib)(
        _build.ptr(qk), _build.ptr(k_max_l), _build.ptr(k_min_l),
        _build.ptr(tab), _build.ptr(out), B, Hkv, G, NPB, bpp, NB, meta_code,
        2 if per_q_head else int(group_agg == "sum"),
        int(qk.dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(lib, code, "estimate (physical)")
    page_scores_physical.launches += 1
    return out


page_scores_physical.launches = 0


def split_query(q: torch.Tensor, Hkv: int, dtype: torch.dtype):
    """relu(q) and min(q, 0) of ``q`` [B, Hq, D], taken in f32 and each
    rounded to ``dtype``, as two [B, Hkv, G, D] f32 tensors."""
    B, Hq, D = q.shape
    qf = q.float().reshape(B, Hkv, Hq // Hkv, D)
    return (qf.clamp(min=0.0).to(dtype).float(),
            qf.clamp(max=0.0).to(dtype).float())


def page_scores_kernel_plain(q: torch.Tensor, k_max: torch.Tensor,
                             k_min: torch.Tensor, group_agg: str = "max",
                             layer=None) -> torch.Tensor:
    """Eager version of the streaming estimate. It differs from
    :func:`page_scores` in one place: relu(q) and min(q, 0) are rounded
    to the metadata dtype (bf16 for bf16 or fp8 metadata, f32 for f32)
    before the products, as the JAX kernel casts them, where
    :func:`page_scores` keeps q in f32. Products accumulate in f32;
    fp8 metadata is read through ``upcast_fp8``, as the JAX kernel reads
    it (denormals flush to zero)."""
    if layer is not None:
        k_max, k_min = k_max[layer], k_min[layer]
    qp, qn = split_query(q, k_max.shape[1], compute_dtype(k_max.dtype))
    s = (torch.einsum("bkgd,bkpd->bkgp", qp, to_f32(k_max))
         + torch.einsum("bkgd,bkpd->bkgp", qn, to_f32(k_min)))
    return _aggregate(s, group_agg)


def page_scores_kernel(q: torch.Tensor, k_max: torch.Tensor,
                       k_min: torch.Tensor, group_agg: str = "max",
                       layer=None) -> torch.Tensor:
    """Criticality scores over logical ``[B, Hkv, P, D]`` metadata, or
    stacked ``[L, B, Hkv, P, D]`` metadata read at ``layer``, with the
    streaming kernel's q cast (:func:`page_scores_kernel_plain`).

    q: [B, Hq, D] un-scaled. Returns [B, Hkv, P] f32.
    """
    if group_agg not in ("max", "sum"):
        raise ValueError(f"unknown group_agg {group_agg!r}")
    if not q.is_cuda:
        return page_scores_kernel_plain(q, k_max, k_min, group_agg, layer)
    if layer is not None:
        k_max, k_min = k_max[layer], k_min[layer]
    meta_code = check_pool_dtype(k_max.dtype, "page metadata")
    if k_min.dtype != k_max.dtype or k_min.shape != k_max.shape:
        raise ValueError("k_max and k_min must share dtype and shape")
    B, Hkv, P, _ = k_max.shape
    G = check_kernel_operands(q, Hkv, k_max, k_min)
    qk = kernel_query(q)
    out = torch.empty((B, Hkv, P), dtype=torch.float32, device=q.device)
    lib = _build.load("estimate")
    code = lib.estimate_launch(
        _build.ptr(qk), _build.ptr(k_max), _build.ptr(k_min), _build.ptr(out),
        B, Hkv, G, P, meta_code,
        int(group_agg == "sum"), int(qk.dtype == torch.bfloat16),
        _build.stream_of(q))
    _build.check(lib, code, "estimate")
    page_scores_kernel.launches += 1
    return out


page_scores_kernel.launches = 0
