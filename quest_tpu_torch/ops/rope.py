"""Rotary position embeddings (counterpart of ``quest_tpu/ops/rope.py``).

Rotate-half convention of HF ``apply_rotary_pos_emb``:
  out[..., :D/2] = x1*cos - x2*sin ;  out[..., D/2:] = x2*cos + x1*sin

On a CUDA tensor :func:`rotate_qk` (and :func:`rotate`) is one launch of
``csrc/rope.cu`` for q and k together, the counterpart of the XLA
fusion of the jitted JAX ``apply_rope``; it gives
:func:`rotate_plain`'s bits. A CPU tensor takes :func:`rotate_plain`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from quest_tpu_torch.config import RopeConfig
from quest_tpu_torch.ops import _build


def _base_inv_freq(head_dim: int, theta: float) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return 1.0 / (theta ** exponent)


def compute_rope_params(cfg: RopeConfig, head_dim: int):
    """Return (inv_freq [D/2] f32 on the CPU, position_scale,
    attention_scaling) for plain, linear, llama3 and yarn rope."""
    inv_freq = _base_inv_freq(head_dim, cfg.theta)
    position_scale = 1.0
    attention_scaling = 1.0

    if cfg.scaling is None:
        pass
    elif cfg.scaling == "linear":
        position_scale = float(cfg.factor)
    elif cfg.scaling == "llama3":
        low_wavelen = cfg.original_max_position_embeddings / cfg.low_freq_factor
        high_wavelen = cfg.original_max_position_embeddings / cfg.high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (cfg.original_max_position_embeddings / wavelen
                  - cfg.low_freq_factor) / (cfg.high_freq_factor - cfg.low_freq_factor)
        smooth = smooth.clamp(0.0, 1.0)
        scaled = inv_freq / cfg.factor
        blended = (1.0 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(wavelen > low_wavelen, scaled,
                               torch.where(wavelen < high_wavelen, inv_freq,
                                           blended))
    elif cfg.scaling == "yarn":
        def find_dim(num_rot):
            return (head_dim * math.log(cfg.original_max_position_embeddings
                                        / (num_rot * 2 * math.pi))) / (2 * math.log(cfg.theta))
        low = max(math.floor(find_dim(cfg.beta_fast)), 0)
        high = min(math.ceil(find_dim(cfg.beta_slow)), head_dim - 1)
        dims = torch.arange(head_dim // 2, dtype=torch.float32)
        ramp = ((dims - low) / max(high - low, 1e-3)).clamp(0.0, 1.0)
        extrap = 1.0 - ramp
        inv_freq = (inv_freq / cfg.factor) * (1.0 - extrap) + inv_freq * extrap
        attention_scaling = float(0.1 * math.log(cfg.factor) + 1.0) * cfg.mscale
    else:
        raise ValueError(f"unknown rope scaling {cfg.scaling!r}")

    return inv_freq, position_scale, attention_scaling


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor,
                 position_scale: float = 1.0,
                 attention_scaling: float = 1.0):
    """(cos, sin) [..., T, 1, D/2] f32 for ``positions [..., T]``; one
    pair serves every layer of a forward pass."""
    pos = positions.float() / position_scale
    angles = pos[..., None] * inv_freq.to(positions.device)  # [..., T, D/2]
    return ((torch.cos(angles) * attention_scaling)[..., None, :],
            (torch.sin(angles) * attention_scaling)[..., None, :])


def rotate_plain(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [..., T, H, D]`` by :func:`rope_cos_sin`'s pair, in f32,
    cast back to x.dtype (plain PyTorch ops)."""
    xf = x.float()
    d2 = x.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [..., T, H, D]`` by :func:`rope_cos_sin`'s pair, in f32,
    cast back to x.dtype: :func:`rotate_qk` of x alone."""
    return rotate_qk(x, None, cos, sin)[0]


def rotate_qk(q: torch.Tensor, k: Optional[torch.Tensor], cos: torch.Tensor,
              sin: torch.Tensor
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """:func:`rotate_plain` of q ``[..., T, Hq, D]`` and of k ``[..., T,
    Hkv, D]`` (or None), into new tensors. On a CUDA tensor one launch of
    ``csrc/rope.cu`` for both: head dim 128, q and k of one dtype (bf16
    or f32) and leading shape, contiguous, and ``cos`` / ``sin`` f32
    ``[..., T, 1, 64]`` of that leading shape, contiguous; anything else
    raises. On a CPU tensor :func:`rotate_plain` of each."""
    if not q.is_cuda:
        return (rotate_plain(q, cos, sin),
                None if k is None else rotate_plain(k, cos, sin))
    lead, D = q.shape[:-2], q.shape[-1]
    if D != 128:
        raise NotImplementedError("the CUDA kernels take head_dim 128")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"rope takes bf16 or f32, got {q.dtype}")
    if k is not None and (k.dtype != q.dtype or k.shape[:-2] != lead
                          or k.shape[-1] != D):
        raise ValueError(f"k {tuple(k.shape)} {k.dtype} does not match q "
                         f"{tuple(q.shape)} {q.dtype}")
    for t in (cos, sin):
        if t.dtype != torch.float32 or t.shape != (*lead, 1, D // 2):
            raise ValueError(f"cos / sin must be f32 {(*lead, 1, D // 2)}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    for t in (q, k, cos, sin):
        if t is not None and (t.device != q.device or not t.is_contiguous()):
            raise ValueError("rope takes contiguous operands on q's device")
    qo = torch.empty_like(q)
    ko = None if k is None else torch.empty_like(k)
    lib = _build.load("rope")
    code = lib.rope_launch(
        _build.ptr(q), _build.ptr(k), _build.ptr(qo), _build.ptr(ko),
        _build.ptr(cos), _build.ptr(sin), math.prod(lead), q.shape[-2],
        0 if k is None else k.shape[-2], int(q.dtype == torch.bfloat16),
        _build.stream_of(q))
    _build.check(lib, code, "rope")
    rotate_qk.launches += 1
    return qo, ko


rotate_qk.launches = 0


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, position_scale: float = 1.0,
               attention_scaling: float = 1.0) -> torch.Tensor:
    """Rotate ``x [..., T, H, D]`` by ``positions [..., T]`` (int).
    Computation in f32, result cast back to x.dtype."""
    return rotate(x, *rope_cos_sin(positions, inv_freq, position_scale,
                                   attention_scaling))
