"""Llama/Mistral-family decoder with Quest sparse decode (counterpart of
``quest_tpu/models/llama.py``).

``QuestModel`` is an ``nn.Module`` holding stacked ``[L, in, out]``
weights as buffers, plain or int8/int4 quantized (every linear is a
``models.quantize.qdot``). Each layer runs RMSNorm (the residual add
before it folded in: one launch of ``ops/rms_norm.py`` on the card), the
q/k/v projections, then either the prefill path (rope, append the chunk:
one launch of ``kv/paged_kv.py:append_prefill_at`` on the card, causal
prefill attention) or the decode path (rope and append of one
token, one launch of ``kv/paged_kv.py:rope_append_decode_at`` on the
card; the first ``skip_layers`` layers attend densely, the others run
estimate -> top-k -> sparse attention, or the fused kernel where
:func:`fused_gate` allows it), then the o-projection and the SwiGLU MLP
(its SiLU product one launch of ``ops/silu_mul.py`` on the card). The cache is
updated in place. Each stage runs inside a trace range named as the JAX
model's ``jax.named_scope`` (:data:`TRACE_RANGES`), opened only while a
profiler is active (:func:`quest_tpu_torch.utils.trace.trace_range`).

Where ``SparseWindowConfig.layer_types`` makes a layer a window layer, it
rotates by the window rope, appends to the window layers' cache
(``cache.window``) and attends to its last ``sliding_window`` keys alone
(``prefill_attention`` and ``dense_decode_attention`` with ``window``);
it never selects. With ``num_experts`` every MLP is the router and the
experts of ``ops/moe.py``. Those stages run in the ranges of
:data:`MOE_WINDOW_RANGES`; the dense Llama layer runs as before.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from quest_tpu_torch.config import ModelConfig, QuestConfig
from quest_tpu_torch.kv.paged_kv import (PagedKVCache, append_prefill_at,
                                         rope_append_decode_at)
from quest_tpu_torch.models.quantize import (QuantizedLinear, qdot,
                                             stack_linears)
from quest_tpu_torch.ops.dense_decode import dense_decode_attention
from quest_tpu_torch.ops.estimate import page_scores_physical
from quest_tpu_torch.ops.fused_decode import fused_sparse_decode
from quest_tpu_torch.ops.moe import (KERNEL_ROWS, moe_experts,
                                     moe_experts_grouped, moe_experts_plain,
                                     moe_route)
from quest_tpu_torch.ops.prefill import prefill_attention
from quest_tpu_torch.ops.rms_norm import rms_norm
from quest_tpu_torch.ops.rope import (compute_rope_params, rope_cos_sin,
                                      rotate_qk)
from quest_tpu_torch.ops.silu_mul import silu_mul
from quest_tpu_torch.ops.sparse_decode import sparse_decode_attention
from quest_tpu_torch.ops.topk import select_pages
from quest_tpu_torch.ops.utils import resolve_device
from quest_tpu_torch.utils.trace import trace_range

Params = Dict[str, object]
LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "ln_attn", "ln_mlp")
# A layer with experts: the router [hid, E] and the experts' stacked
# w_gate, w_up [E, hid, I] and w_down [E, I, hid].
MOE_LAYER_KEYS = LAYER_KEYS + ("w_router",)
# The layer's trace ranges, the JAX model's ``jax.named_scope`` names.
TRACE_RANGES = ("qkv_proj", "rope", "append_kv_prefill", "prefill_attn",
                "append_kv_decode", "quest_fused_decode", "quest_estimate",
                "quest_topk", "quest_sparse_attn", "dense_decode_attn",
                "o_proj", "mlp")
# The ranges of the window layers' attention and of the experts.
MOE_WINDOW_RANGES = ("moe_router", "moe_experts", "window_decode_attn",
                     "window_prefill_attn")


def layer_keys(cfg: ModelConfig) -> tuple:
    return MOE_LAYER_KEYS if cfg.num_experts else LAYER_KEYS


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
    if cfg.num_experts and linear_wrap is not None:
        raise NotImplementedError("quantized experts")
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

    # The embedding is drawn first, so a seed gives a dense model the
    # weights it gave before layers could hold experts.
    embed = normal((V, hid), 1.0, 0.02)
    layers = {
        "wq": stacked("wq", (hid, H * D), hid),
        "wk": stacked("wk", (hid, Hkv * D), hid),
        "wv": stacked("wv", (hid, Hkv * D), hid),
        "wo": stacked("wo", (H * D, hid), H * D),
    }
    if cfg.num_experts:
        E, I = cfg.num_experts, cfg.moe_intermediate_size
        layers.update(w_router=stacked("w_router", (hid, E), hid),
                      w_gate=stacked("w_gate", (E, hid, I), hid),
                      w_up=stacked("w_up", (E, hid, I), hid),
                      w_down=stacked("w_down", (E, I, hid), I))
    else:
        layers.update(w_gate=stacked("w_gate", (hid, inter), hid),
                      w_up=stacked("w_up", (hid, inter), hid),
                      w_down=stacked("w_down", (inter, hid), inter))
    return {
        "embed": embed,
        "layers": dict(
            layers,
            ln_attn=torch.ones((L, hid), dtype=dtype, device=dev),
            ln_mlp=torch.ones((L, hid), dtype=dtype, device=dev)),
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
    through ``models.quantize.qdot``. The ``lm_head`` is kept as given
    (bf16 in a bf16 model, as JAX keeps it) and its product with the f32
    activation is f32, as JAX's dot widens the head: ``qdot`` routes it to
    ``ops/head_gemv.py:head_gemv`` on the card; a quantized head stays
    packed and ``qdot`` makes its product in f32.

    ``linear_hook``, None unless set, is called as ``linear_hook(name,
    layer, x, w)`` in place of ``qdot(x, w)`` for every linear (``layer``
    None for ``lm_head``): AWQ's calibration records the activations
    there (``models/awq.py``).

    On the card, building the model switches TF32 off for CUDA matrix
    products (``torch.backends.cuda.matmul.allow_tf32 = False``, for the
    whole process): the page estimate and the ``lm_head``'s product over
    more than 16 rows are full f32 products, as in the JAX model.

    ``tp_group``, the counterpart of the JAX model's ``tp_axis``: a
    ``torch.distributed`` process group over which this model is one
    tensor-parallel shard (``parallel/tp.py``). ``cfg`` then gives the
    shard's head counts and ``params`` its slices (``parallel/mesh.py:
    shard_params``); the o-projection's and the MLP's outputs are summed
    over the group (Megatron TP) and the vocab-split logits gathered.
    Quest's estimate, top-k and sparse attention need no collective: page
    selection is per KV head and heads are shard-local. Without a group
    the model makes no collective call. The collectives run on the
    current stream, with no host sync.
    """

    def __init__(self, cfg: ModelConfig, quest: QuestConfig, params: Params,
                 tp_group=None):
        super().__init__()
        self.cfg = cfg
        self.quest = quest
        self.tp_group = tp_group
        self.linear_hook = None
        self._bits: Dict[str, int] = {}
        if params["embed"].is_cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
        self.register_buffer("embed", params["embed"])
        for k in layer_keys(cfg):
            self._register_weight(k, params["layers"][k])
        self.register_buffer("final_norm", params["final_norm"])
        self._register_weight("lm_head", params["lm_head"])
        inv_freq, self._pos_scale, self._attn_scale = compute_rope_params(
            cfg.rope, cfg.head_dim)
        self.register_buffer("inv_freq", inv_freq.to(self.embed.device))
        # Each layer's kind and its index in its cache: the full layers'
        # (cache) or the window layers' (cache.window).
        full, win = cfg.full_layers, cfg.window_layers
        self._slot = [(False, full.index(l)) if l in full
                      else (True, win.index(l)) for l in range(cfg.num_layers)]
        if win:
            winv, self._wpos_scale, self._wattn_scale = compute_rope_params(
                cfg.window_rope or cfg.rope, cfg.head_dim)
            self.register_buffer("inv_freq_window",
                                 winv.to(self.embed.device))
        if cfg.num_experts:
            if self._bits or tp_group is not None:
                raise NotImplementedError("experts take bf16 or f32 weights "
                                          "on one device")
            # Distinct experts read, summed over the layers and steps since
            # the caller last zeroed it (ops/moe.py).
            self.register_buffer("experts_read", torch.zeros(
                1, dtype=torch.int32, device=self.embed.device),
                persistent=False)

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

    def _maybe_all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum the row-parallel partial ``x`` over the tp group (JAX's
        ``_maybe_psum``)."""
        if self.tp_group is not None:
            torch.distributed.all_reduce(x, group=self.tp_group)
        return x

    def _gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The vocab-split logits [..., V / tp] of every shard, joined
        along the last axis in shard order (JAX's tiled ``all_gather``)."""
        if self.tp_group is None:
            return logits
        n = torch.distributed.get_world_size(self.tp_group)
        parts = torch.empty((n,) + logits.shape, dtype=logits.dtype,
                            device=logits.device)
        torch.distributed.all_gather(list(parts.unbind(0)),
                                     logits.contiguous(), group=self.tp_group)
        return parts.movedim(0, -2).reshape(*logits.shape[:-1], -1)

    def _linear(self, x, name: str, layer: Optional[int] = None,
                dtype: Optional[torch.dtype] = None):
        w = self.weight(name, layer)
        if self.linear_hook is not None:
            return self.linear_hook(name, layer, x, w)
        return qdot(x, w, dtype)

    def _norm(self, x, pending, weight):
        """``(x + pending, its RMSNorm)``: the residual add folded into the
        norm (one launch on the card); ``(x, its norm)`` where nothing is
        pending."""
        eps = self.cfg.rms_norm_eps
        if pending is None:
            return x, rms_norm(x, weight, eps)
        return rms_norm(pending, weight, eps, residual=x)

    # ------------------------------------------------------------------
    def _attn_decode(self, q, cache: PagedKVCache, layer: int,
                     use_sparse: bool, seq_lens):
        """q: [B, Hq, D]; reads layer ``layer`` of the pool (the cache's
        own index of a full layer). Returns [B, Hq, D] f32."""
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

    def _layer(self, x, pending, l: int, cache: PagedKVCache,
               use_sparse: bool, rope, is_prefill: bool, new_lens, active,
               real=None):
        """One transformer layer; x: [B, T, hid], the residual stream
        without ``pending``, the previous layer's MLP output not yet added
        (None for the first layer), which the layer's first norm adds
        (:meth:`_norm`); rope: the (cos, sin) pair of this pass's
        positions for the layer's kind; active: a decode step's rows with
        a new token (``new_lens > 0``, made once a step); real: the [B * T]
        tokens that are not padding, which alone read experts. A window
        layer works on ``cache.window`` and attends each query's last
        ``sliding_window`` keys. Returns the stream and this layer's MLP
        output, pending."""
        cfg = self.cfg
        window, li = self._slot[l]
        if window:
            cache, W = cache.window, cfg.sliding_window
        else:
            W = 0
        B, T, _ = x.shape
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        sm = 1.0 / math.sqrt(D)
        with trace_range("qkv_proj"):
            x, h = self._norm(x, pending, self.ln_attn[l])
            q = self._linear(h, "wq", l).reshape(B, T, H, D)
            k = self._linear(h, "wk", l).reshape(B, T, Hkv, D)
            v = self._linear(h, "wv", l).reshape(B, T, Hkv, D)

        if is_prefill:
            with trace_range("rope"):
                q, k = rotate_qk(q, k, *rope)
            with trace_range("append_kv_prefill"):
                append_prefill_at(cache, li, k, v, new_lens=new_lens)
            with trace_range("window_prefill_attn" if window
                             else "prefill_attn"):
                attn = prefill_attention(
                    q, cache.kv_pages, cache.seq_lens,
                    cache.seq_lens + new_lens, sm_scale=sm, layer=li,
                    block_tab=cache.block_tab, block_pages=cache.block_pages,
                    window=W)
        else:
            with trace_range("append_kv_decode"):
                # The rope of q and k and the append in one launch.
                # Inactive slots (new_lens == 0) must not fold their
                # garbage key into the page metadata.
                q = rope_append_decode_at(cache, li, q[:, 0], k[:, 0],
                                          v[:, 0], *rope, active=active)
            if window:
                with trace_range("window_decode_attn"):
                    attn = dense_decode_attention(
                        q, cache.kv_pages, cache.seq_lens + 1, sm_scale=sm,
                        layer=li, block_tab=cache.block_tab,
                        block_pages=cache.block_pages, window=W)
            else:
                attn = self._attn_decode(q, cache, li, use_sparse,
                                         cache.seq_lens + 1)
            attn = attn[:, None]

        with trace_range("o_proj"):
            attn = attn.to(x.dtype).reshape(B, T, H * D)
            o = self._maybe_all_reduce(self._linear(attn, "wo", l))
        if cfg.num_experts:
            x, h2 = self._norm(x, o, self.ln_mlp[l])
            return x, self._moe(h2, l, real)
        with trace_range("mlp"):
            x, h2 = self._norm(x, o, self.ln_mlp[l])
            mlp = self._linear(silu_mul(self._linear(h2, "w_gate", l),
                                        self._linear(h2, "w_up", l)),
                               "w_down", l)
        return x, self._maybe_all_reduce(mlp)

    def _moe(self, h2, l: int, real):
        """The router and the experts of layer ``l`` over h2 [B, T, hid];
        tokens not ``real`` read no expert."""
        cfg = self.cfg
        h = h2.reshape(-1, h2.shape[-1])
        with trace_range("moe_router"):
            ids, wts = moe_route(h, self.w_router[l], cfg.num_experts_per_tok)
        experts = (moe_experts_plain if not h.is_cuda else
                   moe_experts_grouped if h.shape[0] > KERNEL_ROWS else
                   moe_experts)
        with trace_range("moe_experts"):
            out = experts(h, ids, wts, self.w_gate[l], self.w_up[l],
                          self.w_down[l], real, self.experts_read)
        return out.reshape(h2.shape)

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
        active = None if is_prefill else new_lens > 0
        real = None
        if cfg.num_experts:
            real = active if not is_prefill else (
                torch.arange(T, device=dev)[None, :]
                < new_lens[:, None]).reshape(-1)
        pending = None
        if cache.window is None:
            n_layers, wrope = cache.kv_pages.shape[0], None
        else:
            n_layers = cfg.num_layers
            wrope = rope_cos_sin(positions, self.inv_freq_window,
                                 self._wpos_scale, self._wattn_scale)
        for l in range(n_layers):
            x, pending = self._layer(x, pending, l, cache,
                                     l >= quest.skip_layers,
                                     wrope if self._slot[l][0] else rope,
                                     is_prefill, new_lens, active, real)
        _, x = self._norm(x, pending, self.final_norm)
        if last_only:
            last = (new_lens.long() - 1).clamp(min=0)
            x = x[torch.arange(B, device=dev), last][:, None]
        logits = self._gather_vocab(
            self._linear(x.float(), "lm_head", dtype=torch.float32))
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
        no host synchronisation: tokens [B] -> all_tokens [B, n] int32.
        The engine compiles it (``QuestEngine._burst_fn``) into ONE graph
        of n steps, n static, as JAX jits it into one dispatch."""
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
        sampled burst needs no host round trip; a compiled step registers
        it with its graph, so a replay draws what this call draws from
        the same generator state."""
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
