"""RMSNorm (counterpart of ``quest_tpu/ops/rms_norm.py``), with the
residual add before it folded in.

Numerics match HF LlamaRMSNorm: variance in f32, then cast to the input
dtype and multiply by the weight in that dtype.

On a CUDA tensor :func:`rms_norm` is one launch of ``csrc/rms_norm.cu``,
the counterpart of the XLA fusion that the JAX package compiles the norm
and the residual add before it into; a CPU tensor takes
:func:`rms_norm_plain`. The kernel gives the plain version's ``h`` bit for
bit and its norm but for the order of the sum of squares (ROADMAP note
d): each row's variance is within 4 f32 ulps of the plain version's, and
given its variance the kernel's norm is :func:`rms_scale_plain`'s bit for
bit, so an output differs only where that moves a rounding.
"""

from __future__ import annotations

from typing import Optional

import torch

from quest_tpu_torch.ops import _build


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
                   residual: Optional[torch.Tensor] = None):
    """Plain PyTorch ops. With ``residual``: ``(h, rms_norm_plain(h))``
    where ``h = x + residual`` in x's dtype."""
    if residual is not None:
        h = x + residual
        return h, rms_norm_plain(h, weight, eps)
    xf = x.float()
    return rms_scale_plain(x, (xf * xf).mean(dim=-1), weight, eps)


def rms_scale_plain(x: torch.Tensor, var: torch.Tensor,
                    weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The norm of ``x`` given each row's mean square ``var`` (x's shape
    without its last axis, f32): the plain ops after the reduction. Given
    the kernel's ``var_out`` it gives the kernel's output bit for bit."""
    dtype = x.dtype
    xf = x.float() * torch.reciprocal(torch.sqrt(var[..., None] + eps))
    return xf.to(dtype) * weight.to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             residual: Optional[torch.Tensor] = None,
             var_out: Optional[torch.Tensor] = None):
    """The norm of ``x [..., H]`` over its last axis, or with ``residual``
    (x's shape and dtype) ``(h, norm of h)`` where ``h = x + residual`` in
    x's dtype. On a CUDA tensor one launch of ``csrc/rms_norm.cu``: x bf16
    or f32, any width; ``weight [H]`` is taken in x's dtype. ``var_out``,
    an f32 tensor of one element a row, receives each row's mean square
    (the card's checks read it). On a CPU tensor :func:`rms_norm_plain`."""
    if not x.is_cuda:
        return rms_norm_plain(x, weight, eps, residual)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"rms_norm takes bf16 or f32, got {x.dtype}")
    H = x.shape[-1]
    if weight.shape != (H,):
        raise ValueError(f"weight {tuple(weight.shape)} does not match "
                         f"width {H}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype):
        raise ValueError(f"residual {tuple(residual.shape)} "
                         f"{residual.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    rows = x.numel() // H
    if var_out is not None and (var_out.dtype != torch.float32
                                or var_out.numel() != rows
                                or not var_out.is_contiguous()):
        raise ValueError("var_out must be a contiguous f32 tensor of one "
                         "element a row")
    xc = x.contiguous()
    rc = None if residual is None else residual.contiguous()
    w = weight.to(x.dtype).contiguous()
    for t in (rc, w, var_out):
        if t is not None and t.device != x.device:
            raise ValueError("rms_norm takes operands on x's device")
    out = torch.empty_like(xc)
    h = None if rc is None else torch.empty_like(xc)
    lib = _build.load("rms_norm")
    code = lib.rms_norm_launch(
        _build.ptr(xc), _build.ptr(rc), _build.ptr(w), _build.ptr(out),
        _build.ptr(h), _build.ptr(var_out), rows, H, eps,
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(lib, code, "rms_norm")
    rms_norm.launches += 1
    return out if h is None else (h, out)


rms_norm.launches = 0
