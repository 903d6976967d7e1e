"""Parameters of the JAX package, given as numpy arrays, as the port's
tensors in the same ``[L, in, out]`` layout; quantized linears (JAX's
``QuantizedLinear`` with numpy ``q``, ``s``, ``inv_s`` and its ``bits``)
become the port's ``models.quantize.QuantizedLinear`` unchanged."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quest_tpu_torch.models.llama import Params
from quest_tpu_torch.models.quantize import QuantizedLinear
from quest_tpu_torch.ops.utils import resolve_device


def _tensor(arr, device: torch.device,
            dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16 reaches numpy as its own dtype, which
        # torch.from_numpy refuses: move the bits as uint16 instead.
        t = torch.from_numpy(np.array(arr).view(np.uint16))
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype or t.dtype)


def _leaf(leaf, device: torch.device, dtype: Optional[torch.dtype]):
    if hasattr(leaf, "q") and hasattr(leaf, "bits"):   # a quantized linear
        inv_s = getattr(leaf, "inv_s", None)
        return QuantizedLinear(
            q=_tensor(leaf.q, device, None), s=_tensor(leaf.s, device, None),
            bits=int(leaf.bits),
            inv_s=None if inv_s is None else _tensor(inv_s, device, None))
    return _tensor(leaf, device, dtype)


def params_from_numpy(tree, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Params:
    """Convert the JAX parameter pytree (``{"embed", "layers": {...},
    "final_norm", "lm_head"}`` of numpy or array-like leaves, or of
    quantized linears with such ``q``, ``s``, ``inv_s``) to tensors on
    ``device``; ``dtype`` casts every plain leaf when given (``q``, ``s``
    and ``inv_s`` keep theirs)."""
    dev = resolve_device(device)
    return {
        "embed": _leaf(tree["embed"], dev, dtype),
        "layers": {k: _leaf(v, dev, dtype)
                   for k, v in tree["layers"].items()},
        "final_norm": _leaf(tree["final_norm"], dev, dtype),
        "lm_head": _leaf(tree["lm_head"], dev, dtype),
    }
