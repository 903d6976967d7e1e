"""Parameters of the JAX package, given as numpy arrays, as the port's
tensors in the same ``[L, in, out]`` layout."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from quest_tpu_torch.models.llama import Params
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


def params_from_numpy(tree, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> Params:
    """Convert the JAX parameter pytree (``{"embed", "layers": {...},
    "final_norm", "lm_head"}`` of numpy or array-like leaves) to tensors
    on ``device``; ``dtype`` casts every leaf when given."""
    dev = resolve_device(device)
    return {
        "embed": _tensor(tree["embed"], dev, dtype),
        "layers": {k: _tensor(v, dev, dtype)
                   for k, v in tree["layers"].items()},
        "final_norm": _tensor(tree["final_norm"], dev, dtype),
        "lm_head": _tensor(tree["lm_head"], dev, dtype),
    }
