"""Products with weight-only quantized weights on the card (no Pallas
counterpart; the JAX package leaves them to XLA, which fuses the
dequantization of ``quest_tpu/models/quantize.py:qdot`` into the dot's
operand read).

Weights are one layer of a ``models.quantize.QuantizedLinear``: ``q``
int8 [in, out] (int4: [in/2, out], the block-split nibble pack), ``s``
f32 [1, out] and optional ``inv_s`` f32 [in] (the AWQ fold).

- :func:`qgemv`: ``x`` [M <= 16, in] times the weights, for the decode
  rows. On a CUDA tensor it launches ``csrc/qgemv.cu``'s
  ``qgemv_mma_kernel`` (bf16 x, the products on the tensor cores) or
  ``qgemv_kernel`` (f32 x, FMA); on a CPU tensor it runs
  :func:`qgemv_plain`, JAX's expression.
- :func:`dequant`: the weights as a bf16 or f32 [in, out] matrix, for the
  prefill rows' ``torch.matmul``. On a CUDA tensor it launches
  ``csrc/qgemv.cu:dequant_kernel``; on a CPU tensor it runs
  :func:`dequant_plain`, bitwise equal to the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.decode_common import sm_count
from quest_tpu_torch.ops.utils import round_up

MAX_ROWS = 16          # rows of x qgemv takes
TILE_N = 256           # output columns a CTA (csrc/qgemv.cu: kQTileN)
CTAS_PER_SM = 2        # resident f32 qgemv CTAs an SM (__launch_bounds__)
MAX_SPLITS = 64        # splits of the input rows at most
# A CTA's fixed cost (x staged, the row lanes reduced, its partial
# stored) in q rows of 256 bytes: ~5 us a wave (a card run with the loads
# and the arithmetic compiled out read 16.3 us for two waves, ~5 of them
# the launch) at the 12.7 GB/s a CTA gets of 3.35 TB/s over 264 CTAs.
SPLIT_COST = 256


def dequant_plain(q: torch.Tensor, s: torch.Tensor,
                  inv_s: Optional[torch.Tensor], bits: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """``quest_tpu/models/quantize.py:dequantize_weight``: ``(float(q) *
    s [* inv_s[:, None]]).to(dtype)``; an int4 pack is unpacked to its low
    nibbles (input rows [0, in/2)) then its high ones, sign-extended by
    arithmetic shifts as JAX does."""
    if bits == 4:
        q = torch.cat([(q << 4) >> 4, q >> 4], dim=-2)
    w = q.float() * s
    if inv_s is not None:
        w = w * inv_s[..., :, None]
    return w.to(dtype)


def qgemv_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                inv_s: Optional[torch.Tensor], bits: int,
                dtype: torch.dtype) -> torch.Tensor:
    """JAX's ``qdot`` expression (without its scheduling barrier): the
    activation folded by ``inv_s`` in its own dtype; int8 ``x @ (float(q)
    * s).to(dtype)``; int4 ``x[..., :half] @ lo + x[..., half:] @ hi``
    with each nibble half dequantized and rounded to ``dtype`` alone.
    ``dtype`` is x's (the model's products never mix dtypes)."""
    if inv_s is not None:
        x = x * inv_s.to(x.dtype)
    if bits == 4:
        half = q.shape[-2]
        lo = (((q << 4) >> 4).float() * s).to(dtype)
        hi = ((q >> 4).float() * s).to(dtype)
        return x[..., :half] @ lo + x[..., half:] @ hi
    return x @ (q.float() * s).to(dtype)


@functools.lru_cache(maxsize=256)   # a decode step asks 225 times
def qgemv_plan(q_rows: int, N: int, sms: int, M: int, bits: int,
               bf16: bool):
    """(chunk, ksplit) of one qgemv launch: q's ``q_rows`` rows are cut
    into ``ksplit`` splits of ``chunk`` rows for each 256-column tile. A
    pure function of shapes and the SM count. The bf16 kernel (tensor
    cores, two CTAs an SM for M <= 8 and one for M <= 16, x staged in bf16
    for 8 or 16 rows, chunks a multiple of 64 rows: 16 for each of its 4
    row warps) and the f32 one
    (FMA, two CTAs an SM, x staged in f32 for M rounded up to a power of
    two, chunks a multiple of 16) each stage at most 48 KB of x. Of the
    splittings that fit, the one with the least modelled time: waves of
    CTAs, each as long as its chunk plus a fixed cost (staging, reduction,
    its partial), in q rows; fewer splits on a tie."""
    tiles = -(-N // TILE_N)
    if bf16:
        mt, xbytes, step = (8, 2, 64) if M <= 8 else (16, 2, 64)
        ctas = 2 if M <= 8 else 1
    else:
        mt = next(m for m in (1, 2, 4, 8, 16) if m >= M)
        xbytes, step, ctas = 4, 16, CTAS_PER_SM
    max_chunk = (48 << 10) // (mt * (2 if bits == 4 else 1) * xbytes)
    best = None
    for want in range(1, min(MAX_SPLITS, max(1, q_rows // step)) + 1):
        chunk = round_up(-(-q_rows // want), step)
        if chunk > max_chunk:
            continue
        ks = -(-q_rows // chunk)
        waves = -(-tiles * ks // (ctas * sms))
        cost = (waves * (chunk + SPLIT_COST + 4 * mt), ks)
        if best is None or cost < best[0]:
            best = (cost, chunk, ks)
    return best[1], best[2]


def _check(dtype, device, q, s, inv_s, bits, K, N):
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}; expected 4 or 8")
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the weight kernels take bf16 or f32 "
                                  f"activations and weights, not {dtype}")
    if N % 16 or (bits == 4 and K % 2):
        raise NotImplementedError(f"the weight kernels take out % 16 == 0 "
                                  f"(and an even in for int4): {K}x{N}")
    if q.dtype != torch.int8 or s.dtype != torch.float32 or (
            inv_s is not None and inv_s.dtype != torch.float32):
        raise TypeError("q must be int8, s and inv_s f32")
    for t in (q, s, inv_s):
        if t is not None and t.device != device:
            raise ValueError("all operands must be on one device")
        if t is not None and not t.is_contiguous():
            raise ValueError("the weight kernels take contiguous operands")


_workspaces = {}


def _workspace(device, parts: int, tiles: int):
    """(partials, tickets) views of buffers cached by device, grown
    (tickets zeroed) when too small; the kernel leaves the tickets at
    zero."""
    part, tick = _workspaces.get(device, (None, None))
    if part is None or part.numel() < parts:
        part = torch.empty(max(parts, 1), dtype=torch.float32, device=device)
    if tick is None or tick.numel() < tiles:
        tick = torch.zeros(tiles, dtype=torch.int32, device=device)
    _workspaces[device] = (part, tick)
    return part, tick


def qgemv(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
          inv_s: Optional[torch.Tensor], bits: int,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x`` [..., in] (at most ``MAX_ROWS`` rows) times one layer's
    quantized weights -> [..., out] in ``dtype`` (default x's; the
    kernel takes only x's own)."""
    dtype = dtype or x.dtype
    if not x.is_cuda:
        return qgemv_plain(x, q, s, inv_s, bits, dtype)
    K = x.shape[-1]
    N = q.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    _check(x2.dtype, x.device, q, s, inv_s, bits, K, N)
    if dtype != x.dtype:
        raise NotImplementedError("qgemv writes x's dtype")
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"qgemv takes 1..{MAX_ROWS} rows, not {M}")
    if q.shape[-2] != (K // 2 if bits == 4 else K) or s.numel() != N or (
            inv_s is not None and inv_s.numel() != K):
        raise ValueError(f"weights {tuple(q.shape)} / {tuple(s.shape)} do "
                         f"not match x [.., {K}] at {bits} bits")
    bf16 = x2.dtype == torch.bfloat16
    chunk, ksplit = qgemv_plan(q.shape[-2], N, sm_count(x.device), M, bits,
                               bf16)
    tiles = -(-N // TILE_N)
    part, tick = _workspace(x.device, ksplit * M * N if ksplit > 1 else 0,
                            tiles)
    out = torch.empty((M, N), dtype=dtype, device=x.device)
    lib = _build.load("qgemv")
    code = lib.qgemv_launch(
        _build.ptr(x2), _build.ptr(q), _build.ptr(s), _build.ptr(inv_s),
        _build.ptr(out), _build.ptr(part), _build.ptr(tick), M, K, N, bits,
        int(bf16), chunk, ksplit, _build.stream_of(x))
    _build.check(lib, code, "qgemv")
    qgemv.launches += 1
    return out.reshape(*x.shape[:-1], N)


qgemv.launches = 0


def _dequant_entry(lib):
    fn = lib.dequant_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def dequant(q: torch.Tensor, s: torch.Tensor, inv_s: Optional[torch.Tensor],
            bits: int, dtype: torch.dtype,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer's weights as a ``dtype`` [in, out] matrix, bitwise equal
    to :func:`dequant_plain`; on the card written into ``out`` when given
    (a buffer of at least in * out elements of ``dtype``)."""
    if not q.is_cuda:
        return dequant_plain(q, s, inv_s, bits, dtype)
    K = q.shape[-2] * (2 if bits == 4 else 1)
    N = q.shape[-1]
    _check(dtype, q.device, q, s, inv_s, bits, K, N)
    if s.numel() != N or (inv_s is not None and inv_s.numel() != K):
        raise ValueError("s / inv_s do not match q")
    if out is None:
        out = torch.empty((K, N), dtype=dtype, device=q.device)
    elif out.dtype != dtype or out.numel() < K * N or not out.is_contiguous():
        raise ValueError("out must be a contiguous buffer of dtype with "
                         "room for in * out elements")
    w = out.view(-1)[:K * N].view(K, N)
    lib = _build.load("qgemv")
    code = _dequant_entry(lib)(
        _build.ptr(q), _build.ptr(s), _build.ptr(inv_s), _build.ptr(w), K, N,
        bits, int(dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(lib, code, "dequant")
    dequant.launches += 1
    return w


dequant.launches = 0
