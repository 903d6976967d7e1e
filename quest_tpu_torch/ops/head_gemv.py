"""The lm_head product of a decode step: f32 ``x`` times a bf16 head, in
f32 (no Pallas counterpart; the JAX package's ``qdot(x.astype(f32),
params["lm_head"], dtype=f32)`` at ``quest_tpu/models/llama.py:329``,
where XLA widens the bf16 head inside the dot).

On a CUDA tensor :func:`head_gemv` launches ``csrc/head_gemv.cu``: the
head is read once as bf16, each weight widened exactly to f32 as it
arrives, f32 FMAs; on a CPU tensor it runs :func:`head_gemv_plain`, the
same values as JAX's product. ``models/quantize.py:qdot`` routes the
model's head product here for up to ``MAX_ROWS`` rows.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.decode_common import sm_count
from quest_tpu_torch.ops.qdot import MAX_ROWS, _workspace
from quest_tpu_torch.ops.utils import round_up

TILE_N = 256           # output columns a CTA (csrc/head_gemv.cu)
# CTAs an SM by rows of x rounded up (the kernel's __launch_bounds__):
# at 3 an SM, M = 2's 501 CTAs of the 4096 x 128256 head ran 1.27 waves
# and read 393 us against 341 at M = 1's single wave (measured on the
# card), so the plan counts waves at these rates.
CTAS_PER_SM = {1: 4, 2: 3, 4: 2, 8: 1, 16: 1}
MAX_SPLITS = 64
SPLIT_COST = 256       # a CTA's fixed cost in rows of w (as qgemv's)
X_SMEM_BYTES = 48 << 10


class HeadPlan(NamedTuple):
    """One launch: w's rows cut into ``ksplit`` splits of ``chunk``."""
    chunk: int
    ksplit: int


def head_gemv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.float()``: JAX's f32 product with the head widened."""
    return x @ w.float()


@functools.lru_cache(maxsize=64)
def head_gemv_plan(K: int, N: int, sms: int, M: int) -> HeadPlan:
    """The launch of one call, a pure function of shapes and the SM count:
    256-column tiles, x's slice staged in f32 for M rounded up to a power
    of two within 48 KB, chunks a multiple of 16 rows; of the splittings
    that fit, the one with the least modelled time (waves of CTAs at
    ``CTAS_PER_SM``, each as long as its chunk plus a fixed cost in
    rows); fewer splits on a tie."""
    tiles = -(-N // TILE_N)
    mt = next(m for m in (1, 2, 4, 8, 16) if m >= M)
    per_sm = CTAS_PER_SM[mt]
    max_chunk = X_SMEM_BYTES // (mt * 4) // 16 * 16
    least = -(-K // max_chunk)
    best = None
    for want in range(least, max(least, min(MAX_SPLITS, K // 16)) + 1):
        chunk = min(round_up(-(-K // want), 16), max_chunk)
        ks = -(-K // chunk)
        waves = -(-tiles * ks // (per_sm * sms))
        cost = (waves * (chunk + SPLIT_COST + 4 * mt), ks)
        if best is None or cost < best[0]:
            best = (cost, chunk, ks)
    return HeadPlan(best[1], best[2])


def head_gemv(x: torch.Tensor, w: torch.Tensor,
              plan: Optional[HeadPlan] = None) -> torch.Tensor:
    """f32 ``x`` [..., K] (at most ``MAX_ROWS`` rows) times bf16 ``w``
    [K, N] -> f32 [..., N]. On a CUDA tensor one launch of
    ``csrc/head_gemv.cu`` (``w`` contiguous, any K and N); ``plan``
    replaces :func:`head_gemv_plan`'s. On a CPU tensor
    :func:`head_gemv_plain`."""
    if not x.is_cuda:
        return head_gemv_plain(x, w)
    if x.dtype != torch.float32 or w.dtype != torch.bfloat16:
        raise TypeError(f"head_gemv takes f32 x and a bf16 w, not {x.dtype} "
                        f"and {w.dtype}")
    K = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"w {tuple(w.shape)} does not match x [.., {K}]")
    if w.device != x.device or not w.is_contiguous():
        raise ValueError("head_gemv takes a contiguous w on x's device")
    N = w.shape[1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"head_gemv takes 1..{MAX_ROWS} rows, not {M}")
    p = plan or head_gemv_plan(K, N, sm_count(x.device), M)
    part = tick = None
    if p.ksplit > 1:
        part, tick = _workspace(x.device, p.ksplit * M * N, -(-N // TILE_N))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = _build.load("head_gemv")
    code = lib.head_gemv_launch(
        _build.ptr(x2), _build.ptr(w), _build.ptr(out), _build.ptr(part),
        _build.ptr(tick), M, K, N, p.chunk, p.ksplit, _build.stream_of(x))
    _build.check(lib, code, "head_gemv")
    head_gemv.launches += 1
    return out.reshape(*x.shape[:-1], N)


head_gemv.launches = 0
