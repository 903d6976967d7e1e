"""AWQ, activation-aware weight quantization (Lin et al., 2306.00978;
counterpart of ``quest_tpu/models/awq.py``).

1. **Calibrate**: one prefill pass over calibration tokens with
   ``QuestModel.linear_hook`` set to a recorder: each linear's input is
   recorded (per layer, in call order) as its per-input-channel mean
   |activation| and a row subsample drawn as JAX draws it
   (``np.random.default_rng(0).permutation(rows)[:max_rows]`` per call),
   so the calibration rows, and the alphas chosen from them, are JAX's.
2. **Search**: per linear and layer, the grid search over the scale
   exponent alpha in [0, 1]: ``s = a_mean ** alpha`` normalised to
   geometric mean 1, ``W * s`` quantized, and the alpha minimising the
   output error ``mean(((X / s) @ Q(W s) - X @ W) ** 2)`` on the sample
   kept (alpha = 0 is plain RTN). In torch on the model's device.
3. **Fold**: ``QuantizedLinear`` with ``inv_s = 1 / s``; ``qdot``
   multiplies the activation by it.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from quest_tpu_torch.models.quantize import (QUANT_KEYS, QuantizedLinear,
                                             dequantize_weight, qdot,
                                             quantize_weight)


def awq_calibrate(model, cache, tokens: torch.Tensor,
                  max_rows: int = 64) -> Dict[str, List[dict]]:
    """One prefill of ``tokens`` [B, T] (on the model's device) with
    every linear's input recorded: ``{name: [{"a_mean": [in] f32,
    "rows": [<=max_rows, in] f32}, ...]}``, one entry a layer in layer
    order (``lm_head`` once). The model and cache must hold plain
    weights."""
    store: Dict[str, List[dict]] = {}

    def record(name, layer, x, w):
        xf = x.float().reshape(-1, x.shape[-1])
        pick = np.random.default_rng(0).permutation(xf.shape[0])[:max_rows]
        store.setdefault(name, []).append({
            "a_mean": xf.abs().mean(dim=0),
            "rows": xf[torch.from_numpy(pick).to(xf.device)]})
        return qdot(x, w)

    model.linear_hook = record
    try:
        model.prefill_last(cache, tokens)
    finally:
        model.linear_hook = None
    return store


def awq_search_scale(w: torch.Tensor, a_mean: torch.Tensor,
                     x_rows: torch.Tensor, bits: int, n_grid: int = 20):
    """Per-layer AWQ scale search on ``w``'s device. w: [in, out];
    a_mean [in] and x_rows [R, in] from calibration. Returns (inv_s [in]
    f32, best alpha, the error at each alpha)."""
    wf = w.float()
    x = x_rows.float().to(wf.device)
    ref = x @ wf
    am = torch.clamp(a_mean.float().to(wf.device), min=1e-5)
    best = (None, None, float("inf"))
    errs = []
    for gi in range(n_grid):
        alpha = gi / (n_grid - 1)
        s = am ** alpha
        s = s / torch.exp(torch.log(s).mean())          # geomean 1
        deq = dequantize_weight(quantize_weight(wf * s[:, None], bits),
                                torch.float32)
        err = float(torch.mean(((x / s) @ deq - ref) ** 2))
        errs.append(err)
        if err < best[2]:
            best = (s, alpha, err)
    s, alpha, _ = best
    return (1.0 / s).float(), alpha, errs


def awq_quantize_params(model, params: Dict[str, Any], cache,
                        tokens: torch.Tensor, bits: int = 4,
                        n_grid: int = 20) -> Dict[str, Any]:
    """Calibrate ``model`` (built on ``params``) over ``tokens``, search
    each linear's scale per layer, and quantize: the linears become
    ``QuantizedLinear`` with ``inv_s``; the embedding and norms pass
    through."""
    calib = awq_calibrate(model, cache, tokens)

    def quant(w, ent):
        inv_s, _, _ = awq_search_scale(w, ent["a_mean"], ent["rows"], bits,
                                       n_grid)
        ql = quantize_weight(w.float() / inv_s[:, None], bits)
        return ql.q, ql.s, inv_s

    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "layers": {}}
    for k, v in params["layers"].items():
        if k not in QUANT_KEYS:
            out["layers"][k] = v
            continue
        ents = calib[k]
        if len(ents) != v.shape[0]:
            raise ValueError(f"{k}: {len(ents)} calibration entries for "
                             f"{v.shape[0]} layers")
        qs, ss, inv = zip(*(quant(v[l], ents[l]) for l in range(v.shape[0])))
        out["layers"][k] = QuantizedLinear(q=torch.stack(qs),
                                           s=torch.stack(ss), bits=bits,
                                           inv_s=torch.stack(inv))
    q, s, inv_s = quant(params["lm_head"], calib["lm_head"][0])
    out["lm_head"] = QuantizedLinear(q=q, s=s, bits=bits, inv_s=inv_s)
    return out
