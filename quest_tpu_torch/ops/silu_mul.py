"""The MLP's SiLU product ``silu(gate) * up`` (the JAX model's
``jax.nn.silu(g) * u``, ``quest_tpu/models/llama.py:281``).

On a CUDA tensor :func:`silu_mul` is one launch of ``csrc/silu_mul.cu``,
the counterpart of the XLA fusion that the JAX package compiles the two
ops into; a CPU tensor takes :func:`silu_mul_plain`. The kernel gives the
plain ops' bits on the card (silu in f32 by the accurate ``expf``,
rounded to the input dtype, then the product in f32, rounded again); only
``expf`` could differ in a bit between the kernel's build and torch's, and
``chip_smoke.py`` holds such elements to 1 ulp.
"""

from __future__ import annotations

import torch

from quest_tpu_torch.ops import _build

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def silu_mul_plain(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ops: ``F.silu(gate) * up``."""
    return torch.nn.functional.silu(gate) * up


def _launch_code(gate: torch.Tensor, up: torch.Tensor) -> int:
    """The checks :func:`silu_mul` makes on a CUDA tensor; the dtype's
    code for the C entry point."""
    if gate.dtype not in _CODES or up.dtype != gate.dtype or (
            up.shape != gate.shape):
        raise TypeError(f"silu_mul takes gate and up of one shape, bf16 or "
                        f"f32, got {gate.dtype} {tuple(gate.shape)} and "
                        f"{up.dtype} {tuple(up.shape)}")
    if up.device != gate.device or not (gate.is_contiguous()
                                        and up.is_contiguous()):
        raise ValueError("silu_mul takes contiguous operands on one device")
    return _CODES[gate.dtype]


def silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up`` in the operands' dtype. On a CUDA tensor one
    launch of ``csrc/silu_mul.cu``: gate and up of one shape and dtype
    (bf16 or f32), contiguous, on one device; anything else raises. On a
    CPU tensor :func:`silu_mul_plain`."""
    if not gate.is_cuda:
        return silu_mul_plain(gate, up)
    dtype_code = _launch_code(gate, up)
    out = torch.empty_like(gate)
    if gate.numel() == 0:
        return out
    lib = _build.load("silu_mul")
    code = lib.silu_mul_launch(_build.ptr(gate), _build.ptr(up),
                               _build.ptr(out), gate.numel(), dtype_code,
                               _build.stream_of(gate))
    _build.check(lib, code, "silu_mul")
    silu_mul.launches += 1
    return out


silu_mul.launches = 0
