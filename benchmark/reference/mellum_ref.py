"""Plain float32 reference of Mellum2 (JetBrains' ``model_type`` "mellum")
served with Quest's sparse decode on its full-attention layers, in plain
PyTorch.

It imports nothing of the program under test. It takes the inputs the
benchmark made (the weights in the port's layout, the document, each
request's prompt tail and the tokens the program served) and works out
everything else again.

The block, as the published ``config.json`` gives it, for each layer:
RMSNorm, the q, k, v projections (no bias, no q/k norm), rope by the
layer's type (``full_attention``: YaRN at ``factor``, its attention
factor ``0.1 ln(factor) + 1`` on cos and sin; ``sliding_attention``:
plain rope), grouped-query attention (full layers: causal over every
earlier key; window layers: over the keys ``p - window + 1 .. p`` of the
query at ``p``, the ``q_idx - kv_idx < sliding_window`` rule of the HF
Mistral/Qwen masks), the o-projection added to the stream, RMSNorm, the
router ``softmax(h @ W_r)`` over the experts, its ``k`` largest weights
renormalised to sum 1, and the sum of those experts' SwiGLU outputs
weighted by them, added to the stream; then the final RMSNorm and the
untied head. Rope angles are float64; every product is float32 with TF32
off. Each expert's tokens are gathered and computed together.

Quest on the full layers from ``skip_layers`` (as layer indices) is
``quest_ref.py``'s: fed-back decode tokens attend to the current page
and the pages their query selects from the pages' min/max keys; prompt
positions attend densely. Window layers never select.

Departures from the published description: the MTP head that the model
card names is not computed (a served greedy step does not use it, and
the config has no key for it); weights are random; everything is float32
(the published weights are bf16).

The control (``low_precision=True``) computes the same in fp8 e4m3 as
``quest_ref.py`` does: weights one scale per output column, activations
one scale per row, keys and values as a cache would store them.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from reference.quest_ref import (Sequence_, Shape, _attend, _page_meta,
                                 _page_select, _rms, _rope, _rope_tables,
                                 fp8_round)

ATTN = ("wq", "wk", "wv", "wo")
EXPERTS = ("w_router", "w_gate", "w_up", "w_down")


@dataclass(frozen=True)
class MellumShape:
    """The sizes the reference needs (plain values, no program types)."""

    quest: Shape            # widths, eps, page, budget, skip_layers
    windowed: Tuple[bool, ...]   # each layer: a window layer
    window: int
    window_theta: float     # the window layers' plain rope
    yarn_factor: float      # the full layers' YaRN
    yarn_original: int
    beta_fast: float
    beta_slow: float
    experts: int
    top_k: int


def _yarn_tables(positions: torch.Tensor, s: MellumShape):
    """cos, sin [n, 1, D/2] of YaRN (HF's ``_compute_yarn_parameters``:
    the ramp between the dims rotating beta_fast and beta_slow times over
    the original length, interpolated frequencies below it), times the
    attention factor 0.1 ln(factor) + 1."""
    D, theta = s.quest.head_dim, s.quest.rope_theta
    base = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                         device=positions.device) / D))

    def dim_of(rot):
        return (D * math.log(s.yarn_original / (rot * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(dim_of(s.beta_fast)), 0)
    high = min(math.ceil(dim_of(s.beta_slow)), D - 1)
    ramp = ((torch.arange(D // 2, dtype=torch.float64,
                          device=positions.device) - low)
            / max(high - low, 1e-3)).clamp(0, 1)
    inv = base / s.yarn_factor * ramp + base * (1 - ramp)
    ang = positions.double()[:, None] * inv[None, :]
    att = 0.1 * math.log(s.yarn_factor) + 1.0
    return ((ang.cos() * att).float()[:, None, :],
            (ang.sin() * att).float()[:, None, :])


def route(h: torch.Tensor, w_router: torch.Tensor, k: int):
    """(ids [n, k], weights [n, k]): the router's softmax over the experts
    of the rows ``h`` [n, hid], its k largest, renormalised to sum 1
    (``norm_topk_prob``)."""
    top = torch.softmax(h @ w_router, dim=-1).topk(k, dim=-1)
    return top.indices, top.values / top.values.sum(-1, keepdim=True)


def _tables(positions, s: MellumShape, window: bool):
    if window:
        return _rope_tables(positions, dataclasses.replace(
            s.quest, rope_theta=s.window_theta))
    return _yarn_tables(positions, s)


@torch.no_grad()
def forward_logits(weights: Dict, s: MellumShape, prefix: torch.Tensor,
                   seqs: Sequence[Sequence_], low_precision: bool = False,
                   block: int = 512, row_block: int = 8192) -> List[Dict]:
    """``quest_ref.forward_logits`` of Mellum2: the logits read where each
    served token was chosen, over ``prefix + seq.tail + seq.served[:-1]``
    for every ``seq`` (the prefix computed once, layer by layer, in
    blocks of queries)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q_shape = s.quest
    dev = weights["embed"].device
    L = weights["layers"]
    H, Hkv, D = q_shape.heads, q_shape.kv_heads, q_shape.head_dim
    scale = 1.0 / math.sqrt(D)
    S = int(prefix.numel())
    W = s.window

    def wmat(t):
        w = t.float()
        return fp8_round(w, dim=-2) if low_precision else w

    def kv_round(t):
        return fp8_round(t) if low_precision else t

    def act(t):
        return fp8_round(t, dim=-1) if low_precision else t

    def embed(t):
        rows = weights["embed"][t].float()
        return fp8_round(rows, dim=-1) if low_precision else rows

    x_pre = (embed(prefix.long().to(dev)) if S else
             torch.zeros((0, q_shape.hidden), device=dev))
    toks = [torch.cat([q.tail.long(), q.served.long()[:-1]]).to(dev)
            for q in seqs]
    xs = [embed(t) for t in toks]
    pos_pre = torch.arange(S, device=dev)
    pos = [S + torch.arange(t.numel(), device=dev) for t in toks]
    n_tail = [int(q.tail.numel()) for q in seqs]

    def qkv(x, l, rope, Wl):
        h = act(_rms(x, L["ln_attn"][l].float(), q_shape.eps))
        q = (h @ Wl["wq"]).view(-1, H, D)
        k = (h @ Wl["wk"]).view(-1, Hkv, D)
        v = (h @ Wl["wv"]).view(-1, Hkv, D)
        return _rope(q, *rope), kv_round(_rope(k, *rope)), kv_round(v)

    def experts_add(x, l, We):
        """x += the experts' output, the router over RMSNorm(x)."""
        h = act(_rms(x, L["ln_mlp"][l].float(), q_shape.eps))
        ids, wts = route(h, We["w_router"], s.top_k)
        out = torch.zeros_like(x)
        for e in range(s.experts):
            tok, slot = torch.nonzero(ids == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            he = h[tok]
            a = act(torch.nn.functional.silu(he @ We["w_gate"][e])
                    * (he @ We["w_up"][e]))
            # A token takes an expert once: no index repeats here.
            out[tok] = out[tok] + (a @ We["w_down"][e]) \
                * wts[tok, slot][:, None]
        return x + out

    def block_add(x, l, attn, Wl, We):
        x = x + act(attn.reshape(x.shape[0], H * D)) @ Wl["wo"]
        for r0 in range(0, x.shape[0], row_block):
            x[r0:r0 + row_block] = experts_add(x[r0:r0 + row_block], l, We)
        return x

    for l in range(q_shape.layers):
        win = s.windowed[l]
        Wl = {k: wmat(L[k][l]) for k in ATTN}
        We = {k: wmat(L[k][l]) for k in EXPERTS}
        sparse = not win and l >= q_shape.skip_layers
        rope_pre = _tables(pos_pre, s, win)
        if S:
            k_pre = torch.empty((S, Hkv, D), device=dev)
            v_pre = torch.empty((S, Hkv, D), device=dev)
            q_pre = torch.empty((S, H, D), device=dev)
            for r0 in range(0, S, row_block):
                r1 = min(S, r0 + row_block)
                rope = (rope_pre[0][r0:r1], rope_pre[1][r0:r1])
                q_pre[r0:r1], k_pre[r0:r1], v_pre[r0:r1] = qkv(
                    x_pre[r0:r1], l, rope, Wl)
            attn = torch.empty((S, H, D), device=dev)
            for b0 in range(0, S, block):
                b1 = min(S, b0 + block)
                k0 = max(0, b0 - W + 1) if win else 0
                kpos = torch.arange(k0, b1, device=dev)
                qpos = torch.arange(b0, b1, device=dev)
                mask = kpos[None, :] <= qpos[:, None]
                if win:
                    mask &= kpos[None, :] > qpos[:, None] - W
                attn[b0:b1] = _attend(q_pre[b0:b1], k_pre[k0:b1],
                                      v_pre[k0:b1], mask[None], scale)
            del q_pre
        else:
            k_pre = v_pre = torch.zeros((0, Hkv, D), device=dev)
        new_xs = []
        for i, x in enumerate(xs):
            q, k, v = qkv(x, l, _tables(pos[i], s, win), Wl)
            k_all = torch.cat([k_pre, k])
            v_all = torch.cat([v_pre, v])
            t_all = pos[i]
            out = torch.empty_like(q)
            kpos = torch.arange(k_all.shape[0], device=dev)
            meta = _page_meta(k_all, q_shape.page) if sparse else None
            for b0 in range(0, q.shape[0], 128):
                b1 = min(q.shape[0], b0 + 128)
                t = t_all[b0:b1]
                causal = kpos[None, :] <= t[:, None]            # [n, Tk]
                if win:
                    causal &= kpos[None, :] > t[:, None] - W
                mask = causal[None].expand(Hkv, -1, -1)
                dec = torch.arange(b0, b1, device=dev) >= n_tail[i]
                if sparse and bool(dec.any()):
                    sel = _page_select(q[b0:b1][dec], meta, t[dec], q_shape)
                    tok_sel = sel[:, :, kpos // q_shape.page]
                    mask = mask.clone()
                    mask[:, dec] &= tok_sel.permute(1, 0, 2)
                out[b0:b1] = _attend(q[b0:b1], k_all, v_all, mask, scale)
            new_xs.append(block_add(x, l, out, Wl, We))
            del k_all, v_all
        xs = new_xs
        if S:
            x_pre = block_add(x_pre, l, attn, Wl, We)
            del attn
        del k_pre, v_pre, Wl, We
    head = wmat(weights["lm_head"])
    fnorm = weights["final_norm"].float()
    results = []
    for i, q in enumerate(seqs):
        xr = xs[i][n_tail[i] - 1:]
        logits = act(_rms(xr, fnorm, q_shape.eps)) @ head        # [n, V]
        served = q.served.long().to(dev)
        top2 = logits.topk(2, dim=-1)
        res = dict(best=top2.values[:, 0], second=top2.values[:, 1],
                   served=logits.gather(1, served[:, None])[:, 0],
                   top=top2.indices[:, 0])
        if q.extra is not None:
            res["extra"] = logits.gather(
                1, q.extra.long().to(dev)[:, None])[:, 0]
        results.append(res)
    return results
