"""Helpers shared by the port's ops."""

from __future__ import annotations

import torch

MASK_VALUE = -1e30  # finite so exp(m_prev - m_new) never hits inf-inf


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


def scaled_query(q: torch.Tensor, sm_scale: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """q arrives un-scaled: scale in f32, then cast to the pool dtype
    before QK, as the JAX kernels do."""
    return (q.float() * sm_scale).to(dtype)


def kernel_query(q: torch.Tensor) -> torch.Tensor:
    """The query as the CUDA kernels read it: bf16 or f32, contiguous,
    un-scaled (the kernels scale it in f32 and round it to the pool
    dtype, as :func:`scaled_query` does)."""
    return (q if q.dtype == torch.bfloat16 else q.float()).contiguous()


def check_pool_dtype(dtype: torch.dtype, what: str = "KV pool") -> None:
    """The kernels take bf16 or f32 pools and metadata; fp8 comes with
    the fp8 slice."""
    if dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        raise NotImplementedError(
            f"fp8 {what}s are not ported yet (they need the upcast_fp8 "
            "device helper)")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"unsupported {what} dtype {dtype}")


def meta_compute_dtype(meta_dtype: torch.dtype) -> torch.dtype:
    """The dtype the metadata products run in: the metadata's own, or
    bf16 below 16 bits (the JAX kernels never round q to fp8)."""
    return meta_dtype if meta_dtype.itemsize >= 2 else torch.bfloat16


def check_kernel_operands(q: torch.Tensor, Hkv: int, *tensors) -> int:
    """Shared checks of the decode-side CUDA wrappers: head dim 128, a
    GQA group in {1, 2, 4, 8}, every operand on q's device and
    contiguous. Returns the group size G."""
    B, Hq, D = q.shape
    if D != 128:
        raise NotImplementedError("the CUDA kernels take head_dim 128")
    G = Hq // Hkv
    if G not in (1, 2, 4, 8) or G * Hkv != Hq:
        raise NotImplementedError(f"GQA group {Hq}/{Hkv} not supported")
    for t in tensors:
        if t.device != q.device:
            raise ValueError("all operands must be on the query's device")
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous operands")
    return G
