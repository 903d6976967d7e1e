"""RMSNorm (counterpart of ``quest_tpu/ops/rms_norm.py``).

Numerics match HF LlamaRMSNorm: variance in f32, then cast to the input
dtype and multiply by the weight in that dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xf = xf * torch.reciprocal(torch.sqrt(var + eps))
    return xf.to(dtype) * weight.to(dtype)
