"""Rotary position embeddings (counterpart of ``quest_tpu/ops/rope.py``).

Rotate-half convention of HF ``apply_rotary_pos_emb``:
  out[..., :D/2] = x1*cos - x2*sin ;  out[..., D/2:] = x2*cos + x1*sin
"""

from __future__ import annotations

import math

import torch

from quest_tpu_torch.config import RopeConfig


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


def rotate(x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [..., T, H, D]`` by :func:`rope_cos_sin`'s pair, in f32,
    cast back to x.dtype."""
    xf = x.float()
    d2 = x.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, position_scale: float = 1.0,
               attention_scaling: float = 1.0) -> torch.Tensor:
    """Rotate ``x [..., T, H, D]`` by ``positions [..., T]`` (int).
    Computation in f32, result cast back to x.dtype."""
    return rotate(x, *rope_cos_sin(positions, inv_freq, position_scale,
                                   attention_scaling))
