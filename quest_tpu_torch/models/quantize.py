"""Weight-only int8/int4 quantization (counterpart of
``quest_tpu/models/quantize.py``).

Symmetric per-output-channel quantization of the stacked ``[L, in,
out]`` linears: ``q = clip(round(w / s), -qmax, qmax)`` with ``s =
max|w| / qmax`` per output column (qmax 127, or 7 for int4 packed two
to a byte with the block-split pack: input rows [0, in/2) in the low
nibbles, [in/2, in) in the high ones). :func:`quantize_weight` and
:func:`dequantize_weight` are bitwise equal to JAX's (round half to
even, the same f32 division and clip).

:func:`qdot` is the model's product ``x @ w`` with a plain or a
quantized weight. On CPU tensors it runs JAX's expression
(``ops/qdot.py:qgemv_plain``). On the card it routes by row count: up to
16 rows (every decode step) launch the ``qgemv`` kernel, which reads the
packed weights once; more rows (prefill) dequantize the layer into a
reusable buffer with the ``dequant`` kernel and multiply with
``torch.matmul``, as the JAX package leaves that product to XLA. A
plain bf16 lm_head (kept as given, as JAX keeps it) with the model's f32
activation routes the same way: up to 16 rows launch
``ops/head_gemv.py:head_gemv``, more widen the head in column chunks
(:func:`widened_product`). There is no fallback: a kernel that fails to
build or launch raises.

JAX's ``slice_layer``, its static ``layer`` index and the
``optimization_barrier`` in its ``qdot`` only steer XLA's scheduler
(hoisting and copies of the stacked weights); PyTorch runs eagerly, so
the port indexes the stacked ``q[l]`` as a view and has none of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from quest_tpu_torch.ops.head_gemv import head_gemv
from quest_tpu_torch.ops.qdot import (MAX_ROWS, dequant, dequant_plain,
                                      qgemv, qgemv_plain)
from quest_tpu_torch.ops.utils import hold

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
HEAD_CHUNK_COLS = 8192     # widened_product's columns a chunk (128 MB at 4096)


@dataclasses.dataclass
class QuantizedLinear:
    """A quantized ``[..., in, out]`` weight: ``q`` int8 ``[..., in,
    out]`` (int4: ``[..., in/2, out]``), ``s`` f32 ``[..., 1, out]``,
    ``inv_s`` f32 ``[..., in]`` or None (the AWQ fold: ``q`` and ``s``
    quantize ``w / inv_s[:, None]`` and :func:`qdot` multiplies the
    activation by ``inv_s``), ``bits`` 8 or 4."""

    q: torch.Tensor
    s: torch.Tensor
    bits: int = 8
    inv_s: Optional[torch.Tensor] = None

    def layer(self, l: int) -> "QuantizedLinear":
        """Layer ``l`` of a stacked weight, as views."""
        return QuantizedLinear(
            q=self.q[l], s=self.s[l], bits=self.bits,
            inv_s=None if self.inv_s is None else self.inv_s[l])

    def tensors(self) -> Dict[str, torch.Tensor]:
        out = {"q": self.q, "s": self.s}
        if self.inv_s is not None:
            out["inv_s"] = self.inv_s
        return out

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors().values())


def quantize_weight(w: torch.Tensor, bits: int = 8) -> QuantizedLinear:
    """Symmetric per-output-channel quantization of ``[..., in, out]``,
    computed on ``w``'s device."""
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}; expected 4 or 8")
    wf = w.float()
    qmax = 127.0 if bits == 8 else 7.0
    s = wf.abs().amax(dim=-2, keepdim=True) / qmax          # [..., 1, out]
    s = torch.clamp(s, min=1e-8)
    q = torch.clamp(torch.round(wf / s), -qmax, qmax).to(torch.int8)
    if bits == 4:
        half = q.shape[-2] // 2
        q = (q[..., :half, :] & 0x0F) | ((q[..., half:, :] & 0x0F) << 4)
    return QuantizedLinear(q=q.contiguous(), s=s, bits=bits)


def dequantize_weight(qw: QuantizedLinear,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The effective weight ``(float(q) * s [* inv_s]).to(dtype)``, in
    eager PyTorch on any device (the ``dequant`` kernel's plain
    version)."""
    return dequant_plain(qw.q, qw.s, qw.inv_s, qw.bits, dtype)


_buffers: Dict[tuple, torch.Tensor] = {}


def _dequant_buffer(device, dtype, numel: int) -> torch.Tensor:
    """The prefill route's weight buffer (and :func:`widened_product`'s
    chunk), one per (device, dtype), grown to the largest seen; a graph
    being captured holds it (``utils.hold``)."""
    buf = _buffers.get((device, dtype))
    if buf is None or buf.numel() < numel:
        _buffers.pop((device, dtype), None)
        buf = _buffers[(device, dtype)] = torch.empty(numel, dtype=dtype,
                                                      device=device)
    hold(buf)
    return buf


def widened_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` [..., K] times a bf16 ``w`` [K, N] in f32 on the card for
    more than ``MAX_ROWS`` rows: ``w`` widened ``HEAD_CHUNK_COLS`` columns
    at a time into the reused f32 buffer, each chunk's product by
    ``torch.matmul`` (TF32 off, as the model sets it). No whole f32 copy
    of ``w`` is made."""
    K, N = w.shape
    x2 = x.reshape(-1, K)
    out = torch.empty((x2.shape[0], N), dtype=torch.float32, device=x.device)
    cols = min(N, HEAD_CHUNK_COLS)
    buf = _dequant_buffer(x.device, torch.float32, K * cols)
    for c0 in range(0, N, cols):
        n = min(cols, N - c0)
        wf = buf[:K * n].view(K, n)
        wf.copy_(w[:, c0:c0 + n])
        out[:, c0:c0 + n] = x2 @ wf
    return out.reshape(*x.shape[:-1], N)


def qdot(x: torch.Tensor, w, dtype: Optional[torch.dtype] = None
         ) -> torch.Tensor:
    """``x @ w`` where ``w`` is a plain tensor or one layer of a
    :class:`QuantizedLinear`; the product is ``dtype`` (default x's). A
    plain bf16 ``w`` with f32 ``x`` (the model's lm_head) gives the f32
    product, as JAX's dot widens the head: up to ``MAX_ROWS`` rows (and on
    the CPU) by ``ops/head_gemv.py:head_gemv``, more by
    :func:`widened_product`."""
    if not isinstance(w, QuantizedLinear):
        if x.dtype == w.dtype:
            return x @ w
        if x.dtype != torch.float32 or w.dtype != torch.bfloat16:
            raise NotImplementedError(f"a plain product of {x.dtype} x and "
                                      f"{w.dtype} w")
        if not x.is_cuda or x.numel() // x.shape[-1] <= MAX_ROWS:
            return head_gemv(x, w)
        return widened_product(x, w)
    dtype = dtype or x.dtype
    if not x.is_cuda:
        return qgemv_plain(x, w.q, w.s, w.inv_s, w.bits, dtype)
    if x.numel() // x.shape[-1] <= MAX_ROWS:
        return qgemv(x, w.q, w.s, w.inv_s, w.bits, dtype)
    if dtype != x.dtype:
        raise NotImplementedError("the prefill route takes dtype == x.dtype")
    K, N = x.shape[-1], w.q.shape[-1]
    wd = dequant(w.q, w.s, None, w.bits, dtype,
                 out=_dequant_buffer(x.device, dtype, K * N))
    if w.inv_s is not None:
        x = x * w.inv_s.to(x.dtype)
    return x @ wd


def stack_linears(leaves) -> Any:
    """Stack per-layer leaves (tensors, or :class:`QuantizedLinear` of
    one bit width) along a new leading layer axis."""
    first = leaves[0]
    if not isinstance(first, QuantizedLinear):
        return torch.stack(leaves)
    return QuantizedLinear(
        q=torch.stack([x.q for x in leaves]),
        s=torch.stack([x.s for x in leaves]), bits=first.bits,
        inv_s=None if first.inv_s is None else torch.stack(
            [x.inv_s for x in leaves]))


def init_params_quantized(cfg, generator: torch.Generator, bits: int = 8,
                          dtype: Optional[torch.dtype] = None,
                          device="cuda") -> Dict[str, Any]:
    """Random parameters quantized tensor by tensor as they are made
    (``models/llama.py:init_params``'s ``linear_wrap``): the bf16
    transient is one layer's tensor. The draws are those of
    :func:`init_params` with the same generator, so the result equals
    ``quantize_params(init_params(...), bits)``."""
    from quest_tpu_torch.models.llama import init_params

    def wrap(name, w):
        if name in QUANT_KEYS or name == "lm_head":
            return quantize_weight(w, bits)
        return w

    return init_params(cfg, generator, dtype=dtype, device=device,
                       linear_wrap=wrap)


def quantize_params(params: Dict[str, Any], bits: int = 8) -> Dict[str, Any]:
    """Quantize every linear of the stacked parameters (the seven layer
    linears and ``lm_head``) one layer at a time on their device; the
    embedding and the norms stay as they are."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "layers": {}}
    for k, v in params["layers"].items():
        out["layers"][k] = (stack_linears([quantize_weight(w, bits)
                                           for w in v])
                            if k in QUANT_KEYS else v)
    out["lm_head"] = quantize_weight(params["lm_head"], bits)
    return out


def weight_bytes(params: Dict[str, Any]) -> int:
    """Bytes of every parameter leaf (quantized leaves at their packed
    width)."""
    def nbytes(v):
        if isinstance(v, QuantizedLinear):
            return v.nbytes
        return v.numel() * v.element_size()
    return (sum(nbytes(v) for v in params["layers"].values())
            + sum(nbytes(params[k]) for k in ("embed", "final_norm",
                                              "lm_head")))
