"""The ``mellum`` family: JetBrains' Mellum2 decoder as ``quest_tpu_torch``
runs it (``config.SparseWindowConfig``: ``layer_types``, ``sliding_window``
and experts; ``models/llama.py``): grouped-query attention, 1024-token
window layers beside full layers, YaRN rope on the full layers and plain
rope on the window layers, and in every layer a softmax router over 64
SwiGLU experts of which a token takes 8. Quest runs on the full layers
from ``skip_layers`` (layer indices) on; window layers never select.

The weights are the port's layout, drawn on the card from the run's seed
as ``families/mistral.py`` draws them, with the experts stacked
``w_gate``, ``w_up`` [L, E, hid, I], ``w_down`` [L, E, I, hid] and the
router ``w_router`` [L, hid, E]. The gains are ``families/mistral.py``'s
(``QK_GAIN``, ``O_GAIN``, ``EMBED_STD``, ``DOWN_GAIN``), for the reasons
given there, with the experts' ``w_down`` at ``DOWN_GAIN``, and the
router at unit gain: logits of s.d. 1 over 64 experts, so a token's top 8
are well apart and a rounding seldom swaps its 8th and 9th.

Work counts (``bench/work.py``'s arguments): every attention linear, the
router and the head are read once a step; the experts read are the
expected union of ``rows`` rows' picks under uniform routing, ``E (1 -
(1 - k/E)^rows)`` a layer; Quest's pages on the full layers are counted
as ``bench/work.py`` counts them; a window layer reads each row's last
``sliding_window`` keys (a document's keys that several rows borrow
counted once).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from bench import manifest
from bench.work import BYTES
from quest_tpu_torch.config import (FULL, WINDOW, RopeConfig,
                                    SparseWindowConfig)
from quest_tpu_torch.models.llama import MOE_WINDOW_RANGES, TRACE_RANGES
from reference.mellum_ref import MellumShape, forward_logits
from reference.quest_ref import Sequence_

_mistral = manifest.family("mistral", Path(__file__).resolve().parents[1])
QK_GAIN, O_GAIN = _mistral.QK_GAIN, _mistral.O_GAIN
EMBED_STD, DOWN_GAIN = _mistral.EMBED_STD, _mistral.DOWN_GAIN
trace_ranges = TRACE_RANGES + MOE_WINDOW_RANGES


def weights(dims: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    """The weights of the decoder of ``dims`` drawn from ``seed`` on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    L, hid = dims["num_hidden_layers"], dims["hidden_size"]
    H, Hkv, D = (dims["num_attention_heads"], dims["num_key_value_heads"],
                 dims["head_dim"])
    E, I, V = (dims["num_experts"], dims["moe_intermediate_size"],
               dims["vocab_size"])

    def draw(shape, std):
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return w.mul_(std)

    def lin(shape, fan_in, gain=1.0):
        return draw(shape, gain / math.sqrt(fan_in))

    ones = dict(dtype=dtype, device=device)
    return {
        "embed": draw((V, hid), EMBED_STD),
        "layers": {
            "wq": lin((L, hid, H * D), hid, QK_GAIN),
            "wk": lin((L, hid, Hkv * D), hid, QK_GAIN),
            "wv": lin((L, hid, Hkv * D), hid),
            "wo": lin((L, H * D, hid), H * D, O_GAIN),
            "w_router": lin((L, hid, E), hid),
            "w_gate": lin((L, E, hid, I), hid),
            "w_up": lin((L, E, hid, I), hid),
            "w_down": lin((L, E, I, hid), I, DOWN_GAIN),
            "ln_attn": torch.ones((L, hid), **ones),
            "ln_mlp": torch.ones((L, hid), **ones),
        },
        "final_norm": torch.ones((hid,), **ones),
        "lm_head": lin((hid, V), hid),
    }


def _rope(p: Dict) -> RopeConfig:
    if p.get("rope_type", "default") == "default":
        return RopeConfig(theta=float(p["rope_theta"]))
    if p["rope_type"] != "yarn":
        raise ValueError(f"rope_type {p['rope_type']!r}")
    att = 0.1 * math.log(p["factor"]) + 1.0
    if abs(p.get("attention_factor", att) - att) > 1e-6:
        raise ValueError("an attention factor other than 0.1 ln(factor) + 1")
    return RopeConfig(theta=float(p["rope_theta"]), scaling="yarn",
                      factor=float(p["factor"]),
                      original_max_position_embeddings=int(
                          p["original_max_position_embeddings"]),
                      beta_fast=float(p["beta_fast"]),
                      beta_slow=float(p["beta_slow"]))


def model_config(dims: Dict) -> SparseWindowConfig:
    """The port's configuration of the decoder of ``dims`` (whose router
    renormalises its top k: ``norm_topk_prob``)."""
    if not dims["norm_topk_prob"]:
        raise ValueError("the port renormalises the router's top k")
    rp = dims["rope_parameters"]
    return SparseWindowConfig(
        vocab_size=dims["vocab_size"], hidden_size=dims["hidden_size"],
        intermediate_size=dims["intermediate_size"],
        num_layers=dims["num_hidden_layers"],
        num_heads=dims["num_attention_heads"],
        num_kv_heads=dims["num_key_value_heads"], head_dim=dims["head_dim"],
        rms_norm_eps=dims["rms_norm_eps"],
        max_position_embeddings=dims["max_position_embeddings"],
        rope=_rope(rp[FULL]), window_rope=_rope(rp[WINDOW]),
        layer_types=tuple(dims["layer_types"]),
        sliding_window=dims["sliding_window"],
        num_experts=dims["num_experts"],
        num_experts_per_tok=dims["num_experts_per_tok"],
        moe_intermediate_size=dims["moe_intermediate_size"],
        tie_word_embeddings=dims["tie_word_embeddings"],
        dtype=getattr(torch, dims["torch_dtype"]))


def mellum_shape(dims: Dict, quest: Dict) -> MellumShape:
    full, win = (dims["rope_parameters"][k] for k in (FULL, WINDOW))
    return MellumShape(
        quest=_mistral.shape_of(dict(dims, rope_theta=full["rope_theta"]),
                                quest),
        windowed=tuple(t == WINDOW for t in dims["layer_types"]),
        window=dims["sliding_window"], window_theta=win["rope_theta"],
        yarn_factor=full["factor"],
        yarn_original=full["original_max_position_embeddings"],
        beta_fast=full["beta_fast"], beta_slow=full["beta_slow"],
        experts=dims["num_experts"], top_k=dims["num_experts_per_tok"])


def reference(weights: Dict, dims: Dict, quest: Dict, prefix: torch.Tensor,
              seqs: Sequence[Sequence_], low_precision: bool = False
              ) -> List[Dict]:
    """``reference/mellum_ref.py:forward_logits`` of the decoder of
    ``dims`` under ``quest`` (queries in blocks of 256 at 128K)."""
    return forward_logits(weights, mellum_shape(dims, quest), prefix, seqs,
                          low_precision=low_precision, block=256)


# Work counts --------------------------------------------------------------

def _params(dims: Dict) -> Tuple[int, int, int]:
    """(attention linears a layer, the router a layer, one expert)."""
    hid, E, I = (dims["hidden_size"], dims["num_experts"],
                 dims["moe_intermediate_size"])
    H, Hkv, D = (dims["num_attention_heads"], dims["num_key_value_heads"],
                 dims["head_dim"])
    return 2 * hid * H * D + 2 * hid * Hkv * D, hid * E, 3 * hid * I


def expected_experts(dims: Dict, rows: int) -> float:
    """Distinct experts that ``rows`` rows read a layer, expected under
    uniform routing: ``E (1 - (1 - k/E)^rows)``."""
    E, k = dims["num_experts"], dims["num_experts_per_tok"]
    return E * (1.0 - (1.0 - k / E) ** rows) if rows > 0 else 0.0


def linear_params(dims: Dict) -> Tuple[int, int]:
    """(parameters that a token multiplies in every layer: the attention
    linears, the router and its k experts; those of the head)."""
    A, R, P = _params(dims)
    L, k = dims["num_hidden_layers"], dims["num_experts_per_tok"]
    return L * (A + R + k * P), dims["hidden_size"] * dims["vocab_size"]


def _kinds(dims: Dict, quest: Dict) -> Tuple[int, int, int]:
    """(full layers read densely, full layers under Quest, window layers)."""
    types = dims["layer_types"]
    dense = sum(1 for l, t in enumerate(types)
                if t == FULL and l < quest["skip_layers"])
    sparse = sum(1 for l, t in enumerate(types)
                 if t == FULL and l >= quest["skip_layers"])
    return dense, sparse, len(types) - dense - sparse


def decode_attention(dims: Dict, quest: Dict, rows: Iterable[tuple],
                     doc_len: Dict) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode step's attention over ``rows`` ``(n,
    doc, uid)``: ``bench/work.py``'s count on the full layers, the last
    ``sliding_window`` keys of each row on the window layers."""
    H, Hkv, D = (dims["num_attention_heads"], dims["num_key_value_heads"],
                 dims["head_dim"])
    W, L = dims["sliding_window"], dims["num_hidden_layers"]
    page = quest["page_size"]
    K = max(1, quest["token_budget"] // page)
    kvb, mb = BYTES[quest["kv_dtype"]], BYTES[quest["meta_dtype"]]
    dense, sparse, win = _kinds(dims, quest)
    tok_kv, page_meta = Hkv * D * 2 * kvb, Hkv * D * 2 * mb
    flops = byt = 0.0
    docs: Dict = {}
    wdocs: Dict = {}
    for n, doc, _ in rows:
        shared = min(doc_len.get(doc, 0), n) if doc is not None else 0
        if shared:
            docs[doc] = max(docs.get(doc, 0), shared)
        P = -(-n // page)
        sel = n if P <= K else (K - 1) * page + (n - (P - 1) * page)
        w = min(n, W)
        w_shared = max(0, shared - (n - w))
        if w_shared:
            wdocs[doc] = max(wdocs.get(doc, 0), w_shared)
        byt += dense * (n - shared) * tok_kv
        byt += sparse * ((P - shared // page) * page_meta + sel * tok_kv)
        byt += win * (w - w_shared) * tok_kv
        byt += L * H * D * (2 + 4)
        flops += 4 * H * D * (dense * n + sparse * (P + sel) + win * w)
    for shared in docs.values():
        byt += (dense * shared * tok_kv
                + sparse * (shared // page) * page_meta)
    for w_shared in wdocs.values():
        byt += win * w_shared * tok_kv
    return flops, byt


def prefill_attention(dims: Dict, quest: Dict, rows: Iterable[tuple],
                      doc_len: Dict) -> Tuple[float, float]:
    """(FLOPs, bytes) of one prefill tick's attention over ``rows``
    ``(offset, n_new, doc, uid)``: causal over every earlier key on the
    full layers, over the last ``sliding_window`` on the window layers."""
    H, Hkv, D = (dims["num_attention_heads"], dims["num_key_value_heads"],
                 dims["head_dim"])
    W = dims["sliding_window"]
    tok_kv = Hkv * D * 2 * BYTES[quest["kv_dtype"]]
    dense, sparse, win = _kinds(dims, quest)
    full = dense + sparse
    flops = byt = 0.0
    docs: Dict = {}
    wdocs: Dict = {}
    for off, n_new, doc, _ in rows:
        if n_new <= 0:
            continue
        ctx = off + n_new
        shared = min(doc_len.get(doc, 0), off) if doc is not None else 0
        if shared:
            docs[doc] = max(docs.get(doc, 0), shared)
        keys = n_new * off + n_new * (n_new + 1) / 2
        # Query i at off + i sees min(off + i + 1, W) keys.
        ramp = max(0, min(n_new, W - off))      # queries below the window
        wkeys = (ramp * off + ramp * (ramp + 1) / 2) + (n_new - ramp) * W
        lo = max(0, off - W + 1)
        w_shared = max(0, shared - lo)
        if w_shared:
            wdocs[doc] = max(wdocs.get(doc, 0), w_shared)
        flops += 4 * H * D * (full * keys + win * wkeys)
        byt += full * ((ctx - shared) * tok_kv + n_new * H * D * (2 + 4))
        byt += win * ((ctx - lo - w_shared) * tok_kv
                      + n_new * H * D * (2 + 4))
    for shared in docs.values():
        byt += full * shared * tok_kv
    for w_shared in wdocs.values():
        byt += win * w_shared * tok_kv
    return flops, byt


def decode_step(dims: Dict, quest: Dict, rows, doc_len: Dict
                ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode step over ``rows``: the attention
    linears, the routers, the expected experts of ``len(rows)`` rows and
    the head read once; the attention's needs; each row's appended K, V
    and page metadata, its embedding row and its logits."""
    rows = list(rows)
    B = len(rows)
    A, R, P = _params(dims)
    L, k = dims["num_hidden_layers"], dims["num_experts_per_tok"]
    hid, V = dims["hidden_size"], dims["vocab_size"]
    Hkv, D = dims["num_key_value_heads"], dims["head_dim"]
    wb = BYTES[dims["torch_dtype"]]
    kvb, mb = BYTES[quest["kv_dtype"]], BYTES[quest["meta_dtype"]]
    f_att, b_att = decode_attention(dims, quest, rows, doc_len)
    flops = 2.0 * B * (L * (A + R + k * P) + hid * V) + f_att
    byt = ((L * (A + R + expected_experts(dims, B) * P) + hid * V) * wb
           + (2 * L + 1) * hid * wb + b_att
           + B * (hid * wb + V * 4 + L * Hkv * D * 2 * (kvb + mb)))
    return flops, byt


def prefill_tick(dims: Dict, quest: Dict, rows, doc_len: Dict) -> float:
    """Model FLOPs of a prefill tick's real tokens: the attention linears,
    the router and k experts of every real token, the attention, and the
    head of each row's last token."""
    lin, head = linear_params(dims)
    real = sum(max(0, r[1]) for r in rows)
    f_att, _ = prefill_attention(dims, quest, rows, doc_len)
    return 2.0 * lin * real + 2.0 * head * sum(1 for r in rows if r[1] > 0) \
        + f_att
