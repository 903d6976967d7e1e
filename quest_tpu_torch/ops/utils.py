"""Helpers shared by the port's ops."""

from __future__ import annotations

import contextlib
import functools
from typing import List

import torch

MASK_VALUE = -1e30  # finite so exp(m_prev - m_new) never hits inf-inf


# Buffers an op caches and replaces when it grows (the decode and qgemv
# workspaces, the dequant buffer): every capture under way
# (``engine/graphs.py``) holds the ones its calls used, so a later growth
# never frees memory that a replay of that graph writes.
_holders: List[list] = []


@contextlib.contextmanager
def holding():
    """Collect what :func:`hold` is given while inside; yields the list."""
    held: list = []
    _holders.append(held)
    try:
        yield held
    finally:
        _holders.remove(held)


def hold(*tensors) -> None:
    for held in _holders:
        held.extend(t for t in tensors if t is not None)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of
    every entry point) raises when no card is present: the CPU is used
    only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev


def upcast_fp8(x: torch.Tensor) -> torch.Tensor:
    """fp8 e4m3 -> bf16 by the JAX kernels' integer recipe
    (``quest_tpu/ops/pallas_utils.py:upcast_fp8``), bit for bit:
    ``bf16 bits = sign * 256 + (em < 8 ? 0 : em * 16 + (120 << 7))`` with
    ``em`` the exponent and mantissa bits. Denormals flush to (signed)
    zero and the NaN codes map to 480. A plain ``.float()`` keeps e4m3
    denormals and so differs from the kernels."""
    u = x.view(torch.uint8).to(torch.int32)
    em = u & 0x7F
    # The same bits widened to f32: the mantissa lands at bit 20 and the
    # exponent is rebiased by 120; the sign is bit 31.
    bits = (torch.where(em < 8, 0, em * (1 << 20) + (120 << 23))
            + torch.where(u >= 0x80, -(1 << 31), 0)).to(torch.int32)
    return bits.view(torch.float32).to(torch.bfloat16)  # exact: 3-bit mantissa


def to_f32(x: torch.Tensor) -> torch.Tensor:
    """Pool or metadata values as the kernels read them, in f32: fp8
    through :func:`upcast_fp8`, other dtypes by a plain cast."""
    return (upcast_fp8(x) if x.dtype == torch.float8_e4m3fn else x).float()


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype q and p are rounded to before the products with a pool
    or metadata of ``dtype``: its own, or bf16 below 16 bits (the JAX
    kernels never round q or p to fp8)."""
    return dtype if dtype.itemsize >= 2 else torch.bfloat16


def scaled_query(q: torch.Tensor, sm_scale: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """q arrives un-scaled: scale in f32, then round to the compute
    dtype of a pool of ``dtype`` before QK, as the JAX kernels do."""
    return (q.float() * sm_scale).to(compute_dtype(dtype))


def kernel_query(q: torch.Tensor) -> torch.Tensor:
    """The query as the CUDA kernels read it: bf16 or f32, contiguous,
    un-scaled (the kernels scale it in f32 and round it to the compute
    dtype, as :func:`scaled_query` does)."""
    return (q if q.dtype == torch.bfloat16 else q.float()).contiguous()


@functools.lru_cache(maxsize=None)
def fp8_cast_codes(device: torch.device, dtype: torch.dtype):
    """The e4m3 codes that torch's cast ``.to(torch.float8_e4m3fn)`` on
    ``device`` gives a finite ``dtype`` value at or past 480, and one in
    (464, 480), which rounds into the NaN code's mantissa: (ovf, carry).
    Torch versions differ there (NaN 0x7F in older ones, 448 = 0x7E in
    newer ones); everywhere else the cast is c10's routine, which
    ``csrc/append.cu`` repeats. Asked once a (device, dtype): a host
    read, so the first call must not come under a graph capture (a
    step's first call runs eagerly before its capture)."""
    x = torch.tensor([1000.0, 470.0], dtype=dtype, device=device)
    ovf, carry = x.to(torch.float8_e4m3fn).view(torch.uint8).tolist()
    return ovf, carry


# The element type code the kernels' C entry points take.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2}


def check_pool_dtype(dtype: torch.dtype, what: str = "KV pool") -> int:
    """The kernels take f32, bf16 or fp8 e4m3 pools and metadata (fp8
    read through the :func:`upcast_fp8` recipe, which is e4m3's only).
    Returns the dtype's code for the C entry points."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"unsupported {what} dtype {dtype} (f32, bf16 or "
                        "float8_e4m3fn)")
    return DTYPE_CODES[dtype]


def padded_group(G: int) -> int:
    """The query heads a kernel CTA takes of a GQA group of ``G``: the
    next of 1, 2, 4, 8 and 16 (padded heads hold a zero query and are
    never written); groups above 16 run ``sub_groups(G)`` CTAs of 16."""
    return next(p for p in (1, 2, 4, 8, 16) if p >= min(G, 16))


def sub_groups(G: int) -> int:
    """CTAs of ``padded_group(G)`` heads a group of ``G`` takes."""
    return -(-G // padded_group(G))


def check_kernel_operands(q: torch.Tensor, Hkv: int, *tensors) -> int:
    """Shared checks of the decode-side CUDA wrappers: head dim 128, the
    query heads a whole number of groups of the Hkv KV heads (any group
    size), every operand on q's device and contiguous. Returns the group
    size G."""
    B, Hq, D = q.shape
    if D != 128:
        raise NotImplementedError("the CUDA kernels take head_dim 128")
    G = Hq // Hkv
    if G < 1 or G * Hkv != Hq:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} KV "
                         "heads")
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all operands must be on the query's device")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous operands")
    return G
