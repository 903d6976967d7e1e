"""Llama/Mistral-family decoder with Quest sparse decode (counterpart of
``quest_tpu/models/llama.py``).

``QuestModel`` is an ``nn.Module`` holding stacked ``[L, in, out]``
weights as buffers, plain or int8/int4 quantized (every linear is a
``models.quantize.qdot``). Each layer runs RMSNorm, the q/k/v projections,
rope, then either the prefill path (append the chunk, causal prefill
attention) or the decode path (append one token; the first
``skip_layers`` layers attend densely, the others run estimate ->
top-k -> sparse attention, or the fused kernel where :func:`fused_gate`
allows it), then the o-projection and the SwiGLU MLP. The cache is
updated in place. Each stage runs inside a trace range named as the JAX
model's ``jax.named_scope`` (:data:`TRACE_RANGES`), opened only while a
profiler is active (:func:`trace_range`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
from torch import nn

from quest_tpu_torch.config import ModelConfig, QuestConfig
from quest_tpu_torch.kv.paged_kv import (PagedKVCache, append_decode_at,
                                         append_prefill_at)
from quest_tpu_torch.models.quantize import (QuantizedLinear, qdot,
                                             stack_linears)
from quest_tpu_torch.ops.dense_decode import dense_decode_attention
from quest_tpu_torch.ops.estimate import page_scores_physical
from quest_tpu_torch.ops.fused_decode import fused_sparse_decode
from quest_tpu_torch.ops.prefill import prefill_attention
from quest_tpu_torch.ops.rms_norm import rms_norm
from quest_tpu_torch.ops.rope import (compute_rope_params, rope_cos_sin,
                                      rotate)
from quest_tpu_torch.ops.sparse_decode import sparse_decode_attention
from quest_tpu_torch.ops.topk import select_pages
from quest_tpu_torch.ops.utils import resolve_device

Params = Dict[str, object]
LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "ln_attn", "ln_mlp")
# The layer's trace ranges, the JAX model's ``jax.named_scope`` names.
TRACE_RANGES = ("qkv_proj", "rope", "append_kv_prefill", "prefill_attn",
                "append_kv_decode", "quest_fused_decode", "quest_estimate",
                "quest_topk", "quest_sparse_attn", "dense_decode_attn",
                "o_proj", "mlp")


def trace_range(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler is active, else a ``nullcontext``: a decode step opens ~12
    ranges a layer, and building them unprofiled would cost host time on
    a host-bound step."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: Optional[torch.dtype] = None,
                device="cuda", linear_wrap=None) -> Params:
    """Random parameters made on ``device`` from ``generator`` (which
    must live on that device), in the JAX package's pytree layout:
    ``{"embed", "layers": {...}, "final_norm", "lm_head"}`` with stacked
    ``[L, in, out]`` layer weights. Each weight is N(0, 1/fan_in) drawn
    in f32 one layer at a time, so the f32 transient stays one layer.

    ``linear_wrap(name, w) -> leaf`` is applied to every linear weight
    as it is made, one layer at a time (``models/quantize.py:
    init_params_quantized`` quantizes there), and the wrapped layers are
    stacked; the draws do not depend on it."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    L, H, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    hid, inter, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    lw = linear_wrap or (lambda name, w: w)

    def normal(shape, fan_in, scale=1.0):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w * (scale / math.sqrt(fan_in))).to(dtype)

    def stacked(name, per_shape, fan_in):
        if linear_wrap is not None:
            return stack_linears([lw(name, normal(per_shape, fan_in))
                                  for _ in range(L)])
        out = torch.empty((L,) + per_shape, dtype=dtype, device=dev)
        for l in range(L):
            out[l] = normal(per_shape, fan_in)
        return out

    return {
        "embed": normal((V, hid), 1.0, 0.02),
        "layers": {
            "wq": stacked("wq", (hid, H * D), hid),
            "wk": stacked("wk", (hid, Hkv * D), hid),
            "wv": stacked("wv", (hid, Hkv * D), hid),
            "wo": stacked("wo", (H * D, hid), H * D),
            "w_gate": stacked("w_gate", (hid, inter), hid),
            "w_up": stacked("w_up", (hid, inter), hid),
            "w_down": stacked("w_down", (inter, hid), inter),
            "ln_attn": torch.ones((L, hid), dtype=dtype, device=dev),
            "ln_mlp": torch.ones((L, hid), dtype=dtype, device=dev),
        },
        "final_norm": torch.ones((hid,), dtype=dtype, device=dev),
        "lm_head": lw("lm_head", normal((hid, V), hid)),
    }


def fused_gate(quest: QuestConfig, max_pages: int, block_pages: int) -> bool:
    """Whether a sparse layer runs the fused kernel: the JAX model's
    gate, condition for condition (per-KV-head selection; a pool of at
    least 128 pages that is a multiple, at least twice over, of
    max(64, block_pages); block_pages compatible with the 64-page
    quantum; at most 256 selection slots). Elsewhere the three-call
    pipeline runs, as in JAX."""
    fq = max(64, block_pages)
    return (quest.fused_decode
            and quest.selection == "per_kv_head"
            and max_pages >= 128
            and (64 % block_pages == 0 or block_pages % 64 == 0)
            and max_pages % fq == 0
            and max_pages >= 2 * fq
            and quest.page_budget <= 256)


class QuestModel(nn.Module):
    """The decoder bound to its configuration and weights.

    ``params`` is the pytree of :func:`init_params` or
    ``models.convert.params_from_numpy``; its tensors become buffers. A
    linear may be a ``models.quantize.QuantizedLinear`` (int8 or int4):
    its ``q``, ``s`` and ``inv_s`` become buffers ``<name>_q``,
    ``<name>_s`` and ``<name>_inv_s`` and every product with it goes
    through ``models.quantize.qdot``. The f32 ``lm_head`` product of the
    JAX model is kept by casting a plain head to f32 once here (the bf16
    copy is not kept); a quantized head stays packed and ``qdot`` makes
    its product in f32.

    ``linear_hook``, None unless set, is called as ``linear_hook(name,
    layer, x, w)`` in place of ``qdot(x, w)`` for every linear (``layer``
    None for ``lm_head``): AWQ's calibration records the activations
    there (``models/awq.py``).

    On the card, building the model switches TF32 off for CUDA matrix
    products (``torch.backends.cuda.matmul.allow_tf32 = False``, for the
    whole process): the page estimate and the f32 ``lm_head`` are full
    f32 products, as in the JAX model.
    """

    def __init__(self, cfg: ModelConfig, quest: QuestConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.quest = quest
        self.linear_hook = None
        self._bits: Dict[str, int] = {}
        if params["embed"].is_cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
        self.register_buffer("embed", params["embed"])
        for k in LAYER_KEYS:
            self._register_weight(k, params["layers"][k])
        self.register_buffer("final_norm", params["final_norm"])
        head = params["lm_head"]
        self._register_weight("lm_head", head if isinstance(
            head, QuantizedLinear) else head.float())
        inv_freq, self._pos_scale, self._attn_scale = compute_rope_params(
            cfg.rope, cfg.head_dim)
        self.register_buffer("inv_freq", inv_freq.to(self.embed.device))

    def _register_weight(self, name: str, w) -> None:
        if isinstance(w, QuantizedLinear):
            self._bits[name] = w.bits
            for part, t in w.tensors().items():
                self.register_buffer(f"{name}_{part}", t)
        else:
            self.register_buffer(name, w)

    def weight(self, name: str, layer: Optional[int] = None):
        """Linear ``name`` (of layer ``layer``, or the whole stack): a
        tensor view, or a :class:`QuantizedLinear` of views."""
        bits = self._bits.get(name)
        if bits is None:
            w = getattr(self, name)
            return w if layer is None else w[layer]
        w = QuantizedLinear(q=getattr(self, name + "_q"),
                            s=getattr(self, name + "_s"), bits=bits,
                            inv_s=getattr(self, name + "_inv_s", None))
        return w if layer is None else w.layer(layer)

    def _linear(self, x, name: str, layer: Optional[int] = None,
                dtype: Optional[torch.dtype] = None):
        w = self.weight(name, layer)
        if self.linear_hook is not None:
            return self.linear_hook(name, layer, x, w)
        return qdot(x, w, dtype)

    # ------------------------------------------------------------------
    def _attn_decode(self, q, cache: PagedKVCache, layer: int,
                     use_sparse: bool, seq_lens):
        """q: [B, Hq, D]; reads layer ``layer`` of the pool. Returns
        [B, Hq, D] f32."""
        cfg, quest = self.cfg, self.quest
        sm = 1.0 / math.sqrt(cfg.head_dim)
        if use_sparse and fused_gate(quest, cache.max_pages,
                                     cache.block_pages):
            with trace_range("quest_fused_decode"):
                return fused_sparse_decode(
                    q, cache.kv_pages, cache.k_max, cache.k_min, seq_lens,
                    sm_scale=sm, budget_pages=quest.page_budget,
                    group_agg=quest.group_agg, layer=layer,
                    block_tab=cache.block_tab, block_pages=cache.block_pages)
        if use_sparse:
            per_q = quest.selection == "per_q_head"
            with trace_range("quest_estimate"):
                scores = page_scores_physical(
                    q, cache.k_max[layer], cache.k_min[layer],
                    cache.block_tab, group_agg=quest.group_agg,
                    per_q_head=per_q)
            with trace_range("quest_topk"):
                idx, num_valid = select_pages(scores, seq_lens,
                                              quest.page_size,
                                              quest.page_budget)
            with trace_range("quest_sparse_attn"):
                return sparse_decode_attention(
                    q, cache.kv_pages, idx, num_valid, seq_lens, sm_scale=sm,
                    layer=layer, block_tab=cache.block_tab,
                    block_pages=cache.block_pages, per_q_head=per_q)
        with trace_range("dense_decode_attn"):
            return dense_decode_attention(
                q, cache.kv_pages, seq_lens, sm_scale=sm, layer=layer,
                block_tab=cache.block_tab, block_pages=cache.block_pages)

    def _layer(self, x, l: int, cache: PagedKVCache, use_sparse: bool,
               rope, is_prefill: bool, new_lens):
        """One transformer layer; x: [B, T, hid]; rope: the (cos, sin)
        pair of this pass's positions."""
        cfg = self.cfg
        B, T, _ = x.shape
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        sm = 1.0 / math.sqrt(D)
        with trace_range("qkv_proj"):
            h = rms_norm(x, self.ln_attn[l], cfg.rms_norm_eps)
            q = self._linear(h, "wq", l).reshape(B, T, H, D)
            k = self._linear(h, "wk", l).reshape(B, T, Hkv, D)
            v = self._linear(h, "wv", l).reshape(B, T, Hkv, D)
        with trace_range("rope"):
            q = rotate(q, *rope)
            k = rotate(k, *rope)

        if is_prefill:
            with trace_range("append_kv_prefill"):
                append_prefill_at(cache, l, k, v, new_lens=new_lens)
            with trace_range("prefill_attn"):
                attn = prefill_attention(
                    q, cache.kv_pages, cache.seq_lens,
                    cache.seq_lens + new_lens, sm_scale=sm, layer=l,
                    block_tab=cache.block_tab, block_pages=cache.block_pages)
        else:
            with trace_range("append_kv_decode"):
                # Inactive slots (new_lens == 0) must not fold their
                # garbage key into the page metadata.
                append_decode_at(cache, l, k[:, 0], v[:, 0],
                                 active=new_lens > 0)
            attn = self._attn_decode(q[:, 0], cache, l, use_sparse,
                                     cache.seq_lens + 1)[:, None]

        with trace_range("o_proj"):
            attn = attn.to(x.dtype).reshape(B, T, H * D)
            x = x + self._linear(attn, "wo", l)
        with trace_range("mlp"):
            h2 = rms_norm(x, self.ln_mlp[l], cfg.rms_norm_eps)
            gate = torch.nn.functional.silu(self._linear(h2, "w_gate", l))
            mlp = self._linear(gate * self._linear(h2, "w_up", l), "w_down", l)
        return x + mlp

    @torch.no_grad()
    def _forward(self, cache: PagedKVCache, tokens: torch.Tensor,
                 is_prefill: bool, new_lens: Optional[torch.Tensor],
                 last_only: bool = False) -> torch.Tensor:
        cfg, quest = self.cfg, self.quest
        B, T = tokens.shape
        dev = tokens.device
        if new_lens is None:
            new_lens = torch.full((B,), T, dtype=torch.int32, device=dev)
        new_lens = new_lens.to(torch.int32)
        x = self.embed[tokens.long()].to(cfg.dtype)
        positions = (cache.seq_lens[:, None]
                     + torch.arange(T, dtype=torch.int32, device=dev)[None, :])
        rope = rope_cos_sin(positions, self.inv_freq, self._pos_scale,
                            self._attn_scale)
        for l in range(cache.kv_pages.shape[0]):
            x = self._layer(x, l, cache, l >= quest.skip_layers, rope,
                            is_prefill, new_lens)
        x = rms_norm(x, self.final_norm, cfg.rms_norm_eps)
        if last_only:
            last = (new_lens.long() - 1).clamp(min=0)
            x = x[torch.arange(B, device=dev), last][:, None]
        logits = self._linear(x.float(), "lm_head", dtype=torch.float32)
        cache.seq_lens += new_lens
        return logits

    # Public steps ------------------------------------------------------
    def prefill(self, cache: PagedKVCache, tokens: torch.Tensor,
                new_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens: [B, T] (padded); returns logits [B, T, V] f32."""
        return self._forward(cache, tokens, True, new_lens)

    def prefill_last(self, cache: PagedKVCache, tokens: torch.Tensor,
                     new_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prefill returning logits only at each row's last real token:
        [B, 1, V] f32."""
        return self._forward(cache, tokens, True, new_lens, last_only=True)

    def decode_step(self, cache: PagedKVCache, tokens: torch.Tensor,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens: [B]; returns logits [B, V] f32. Slots with
        ``active=False`` write into scratch and do not advance."""
        new_lens = None if active is None else active.to(torch.int32)
        return self._forward(cache, tokens[:, None], False, new_lens)[:, 0]

    def decode_token_step(self, cache: PagedKVCache, tokens: torch.Tensor,
                          active: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """One greedy decode step on the device: tokens [B] -> next
        tokens [B] int32, with no host synchronisation."""
        logits = self.decode_step(cache, tokens, active)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def decode_token_burst(self, cache: PagedKVCache, tokens: torch.Tensor,
                           n: int, active: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """``n`` greedy decode steps, each argmax fed straight back, with
        no host synchronisation: tokens [B] -> all_tokens [B, n] int32."""
        outs = []
        for _ in range(n):
            tokens = self.decode_token_step(cache, tokens, active)
            outs.append(tokens)
        return torch.stack(outs, dim=1)

    def decode_nll_step(self, cache: PagedKVCache, tokens: torch.Tensor,
                        targets: torch.Tensor,
                        active: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """Teacher-forced decode step: the negative log-likelihood of
        ``targets`` [B] under the step's logits, ``logsumexp - logit
        [target]`` [B] f32, left on the device."""
        logits = self.decode_step(cache, tokens, active).float()
        tgt = torch.gather(logits, 1, targets.long()[:, None])[:, 0]
        return torch.logsumexp(logits, dim=-1) - tgt

    def decode_sample_step(self, cache: PagedKVCache, tokens: torch.Tensor,
                           generator: torch.Generator, temps: torch.Tensor,
                           active: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """:meth:`decode_token_step` with sampling on the device: rows
        with ``temps > 0`` draw from ``softmax(logits / temp)``, the
        others take the argmax (:func:`sample_tokens`). ``generator``
        lives on the model's device and advances with each call, so a
        sampled burst needs no host round trip."""
        logits = self.decode_step(cache, tokens, active)
        return sample_tokens(logits, temps, generator)


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """Per-row sampling of logits [B, V] by Gumbel-max, the method of
    ``jax.random.categorical``: ``argmax(logits / t + g)`` with ``g =
    -log(E)``, ``E ~ Exp(1)`` drawn from ``generator``, for rows with
    ``temps > 0``; the argmax for the others. Returns [B] int32. The
    distribution is JAX's, the random bits are not."""
    logits = logits.float()
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    gumbel = -torch.empty_like(logits).exponential_(generator=generator).log()
    drawn = torch.argmax(logits / safe_t + gumbel, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temps > 0, drawn, greedy).to(torch.int32)
