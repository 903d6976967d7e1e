"""Sparse experts: the router and the experts' SwiGLU products (no
counterpart in the JAX package, which has no experts).

A token's router logits ``h @ w_router`` in f32, their softmax, the
``k`` largest and their weights, renormalised to sum 1:
:func:`moe_route`. Its output is the sum over those ``k`` experts of
``weight * (silu(h @ w_gate[e]) * (h @ w_up[e])) @ w_down[e]``:
:func:`moe_experts`, every product rounded to the weights' dtype as the
dense MLP rounds its own (``ops/silu_mul.py``).

On a CUDA tensor the router is one launch of ``csrc/moe.cu``
(``moe_route_kernel`` over a decode step's rows, ``moe_route_chunk_kernel``
over more than :data:`KERNEL_ROWS`, so a profile tells the two apart).
The experts take one of three paths, chosen by the caller
(``models/llama.py``) by device and row count:

- :func:`moe_experts`: up to :data:`KERNEL_ROWS` rows (a decode step) on
  the card, two launches that read only the experts that some active row
  picked and need no host read, so a captured decode step holds them;
- :func:`moe_experts_grouped`: more rows (a prefill chunk) on the card,
  grouped products over each expert's own tokens (``torch._grouped_mm``)
  with the groups found on the device, no host read either;
- :func:`moe_experts_plain`: a loop over the experts in plain PyTorch
  ops, the CPU's path and the version both others are held to.

``counter`` (an int32 [1] tensor on the device), where given, gains the
number of distinct experts read: the run's ``experts_read``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.silu_mul import silu_mul, silu_mul_plain

# Rows a call of the experts' kernels takes (rows x k pairs <= 1024).
KERNEL_ROWS = 16


def moe_route_plain(h: torch.Tensor, w_router: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids [N, k] int32, weights [N, k] f32) of rows ``h`` [N, hid] under
    the router ``w_router`` [hid, E], in plain PyTorch ops."""
    logits = h.float() @ w_router.float()
    top = torch.softmax(logits, dim=-1).topk(k, dim=-1)
    wts = top.values / top.values.sum(dim=-1, keepdim=True)
    return top.indices.to(torch.int32), wts


def moe_route(h: torch.Tensor, w_router: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_route_plain`; on a CUDA tensor one launch (bf16 rows and
    router, at most 64 experts; ties go to the lower expert id), of
    ``moe_route_chunk_kernel`` over more than :data:`KERNEL_ROWS` rows."""
    if not h.is_cuda:
        return moe_route_plain(h, w_router, k)
    N, H = h.shape
    E = w_router.shape[-1]
    if h.dtype != torch.bfloat16 or w_router.dtype != torch.bfloat16 or (
            E > 64 or not (h.is_contiguous() and w_router.is_contiguous())):
        raise ValueError("the router kernel takes contiguous bf16 rows and "
                         "a router of at most 64 experts")
    ids = torch.empty((N, k), dtype=torch.int32, device=h.device)
    wts = torch.empty((N, k), dtype=torch.float32, device=h.device)
    lib = _build.load("moe")
    code = lib.moe_route_launch(_build.ptr(h), _build.ptr(w_router),
                                _build.ptr(ids), _build.ptr(wts), N, H, E, k,
                                _build.stream_of(h))
    _build.check(lib, code, "moe_route")
    moe_route.launches += 1
    return ids, wts


moe_route.launches = 0


def _weighted_sum(y: torch.Tensor, wts: torch.Tensor,
                  active: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """Each row's k expert outputs ``y`` [N * k, hid] weighted and summed
    in f32, rounded to ``dtype``; rows not active give zeros. Over more
    than :data:`KERNEL_ROWS` rows (a prefill chunk) one slot at a time, so
    no f32 copy of every pair's output is made."""
    N, k = wts.shape
    yv = y.view(N, k, -1)
    if N <= KERNEL_ROWS:
        out = (yv.float() * wts[..., None]).sum(dim=1)
    else:
        out = yv[:, 0].float() * wts[:, :1]
        for j in range(1, k):
            out += yv[:, j].float() * wts[:, j:j + 1]
    if active is not None:
        out = torch.where(active[:, None], out, torch.zeros_like(out))
    return out.to(dtype)


def moe_experts_plain(h, ids, wts, w_gate, w_up, w_down,
                      active: Optional[torch.Tensor] = None,
                      counter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One expert at a time: the (row, slot) pairs of the active rows that
    picked it, their SwiGLU products (``silu_mul_plain``), each rounded to
    h's dtype. Plain PyTorch ops with a host read an expert. h [N, hid];
    ids, wts [N, k]; w_gate, w_up [E, hid, I]; w_down [E, I, hid].
    Returns [N, hid] in h's dtype."""
    N, H = h.shape
    k = ids.shape[1]
    E = w_gate.shape[0]
    pair_e = ids.long().flatten()
    if active is not None:     # inactive rows' pairs go to bucket E
        pair_e = torch.where(active.repeat_interleave(k), pair_e,
                             torch.full_like(pair_e, E))
    if counter is not None:
        read = torch.bincount(pair_e, minlength=E + 1)[:E] > 0
        counter += read.sum().to(counter.dtype)
    y = torch.zeros(N * k, H, dtype=h.dtype, device=h.device)
    for e in range(E):
        pairs = torch.nonzero(pair_e == e).flatten()
        if pairs.numel() == 0:
            continue
        x = h[pairs // k]
        wg, wu, wd = (w[e].to(h.dtype) for w in (w_gate, w_up, w_down))
        y[pairs] = silu_mul_plain(x @ wg, x @ wu) @ wd
    return _weighted_sum(y, wts, active, h.dtype)


def moe_experts_grouped(h, ids, wts, w_gate, w_up, w_down,
                        active: Optional[torch.Tensor] = None,
                        counter: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """:func:`moe_experts_plain` as grouped products: the (row, slot) pairs
    sorted by expert (pairs of rows not active last, their products never
    read), each expert's products over its own pairs by
    ``torch._grouped_mm`` with the groups' end offsets found on the
    device, so nothing is read on the host. A prefill chunk's path on the
    card."""
    N, H = h.shape
    k = ids.shape[1]
    E = w_gate.shape[0]
    pair_e = ids.long()
    if active is not None:     # inactive rows' pairs go to bucket E
        pair_e = torch.where(active[:, None], pair_e,
                             torch.full_like(pair_e, E))
    pair_e = pair_e.flatten()
    order = torch.argsort(pair_e, stable=True)
    ends = torch.searchsorted(pair_e[order],
                              torch.arange(1, E + 1, device=h.device))
    if counter is not None:
        counter += (torch.diff(ends, prepend=ends[:1] * 0) > 0).sum().to(
            counter.dtype)
    offs = ends.to(torch.int32)
    xs = h[order // k]
    w_gate, w_up, w_down = (w.to(h.dtype) for w in (w_gate, w_up, w_down))
    act = silu_mul(torch._grouped_mm(xs, w_gate, offs=offs),
                   torch._grouped_mm(xs, w_up, offs=offs))
    y = torch.empty_like(xs)
    y[order] = torch._grouped_mm(act, w_down, offs=offs)
    return _weighted_sum(y, wts, active, h.dtype)


def moe_experts(h, ids, wts, w_gate, w_up, w_down,
                active: Optional[torch.Tensor] = None,
                counter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The experts' weighted output [N, hid] of rows ``h`` [N, hid] routed
    to ``ids`` with ``wts`` (:func:`moe_route`); rows with ``active``
    False (a decode step's idle slots, a chunk's padding) read no expert
    and give zeros. CUDA tensors of at most :data:`KERNEL_ROWS` rows: two
    launches of ``csrc/moe.cu`` (bf16, contiguous, hid and I multiples of
    8) and the weighted sum."""
    N, H = h.shape
    if not h.is_cuda or N > KERNEL_ROWS:
        raise ValueError(f"the experts' kernels take at most {KERNEL_ROWS} "
                         f"rows on the card, got {N} on {h.device}")
    k = ids.shape[1]
    E, _, I = w_gate.shape
    for t in (h, w_gate, w_up, w_down):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError("the experts' kernels take contiguous bf16 "
                             "rows and weights")
    act = torch.empty((N * k, I), dtype=h.dtype, device=h.device)
    y = torch.empty((N * k, H), dtype=h.dtype, device=h.device)
    lib = _build.load("moe")
    fn = lib.moe_experts_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    code = fn(_build.ptr(h), _build.ptr(ids), _build.ptr(active),
              _build.ptr(w_gate), _build.ptr(w_up), _build.ptr(w_down),
              _build.ptr(act), _build.ptr(y), _build.ptr(counter), N, k, H, I,
              E, _build.stream_of(h))
    _build.check(lib, code, "moe_experts")
    moe_experts.launches += 1
    # Inactive rows' pairs are never written: their garbage is masked.
    return _weighted_sum(y, wts, active, h.dtype)


moe_experts.launches = 0
