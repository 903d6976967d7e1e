"""Plain float32 reference of a Llama/Mistral-family decoder served with
Quest's sparse decode, in plain PyTorch.

It imports nothing of the program under test. It takes the inputs the
benchmark made (the weights in the port's layout, the document, each
request's prompt tail and the tokens the program served) and works out
everything else again: the keys and values, the per-page min/max keys,
the page selection and the logits.

The forward pass: RMSNorm, rotate-half rope at the configuration's theta
(angles in float64), grouped-query attention, the SwiGLU MLP, a final
RMSNorm and the head. Every matrix product is float32 with TF32 off.

Quest's decode semantics (the paper's): a token fed back by decoding at
position ``t`` sees ``t + 1`` tokens; in layers ``>= skip_layers`` it
attends only to the pages that its query selects: the current page
``t // page`` always, and the ``budget / page - 1`` pages with the
highest bound ``sum_g sum_d max(q_gd * maxK_pd, q_gd * minK_pd)``
(summed over the KV head's query group; ``maxK``/``minK`` the page's
element-wise key extremes, after rope). Where the sequence has no more
pages than the budget, every page is kept. Prompt positions (the
document and the question) attend densely and causally, as do all
positions in the first ``skip_layers`` layers.

The control (``low_precision=True``) computes the same in the nearest
precision below bf16, fp8 e4m3: every weight matrix rounded with one
scale per output column (the embedding one per row), every matrix
product's activations with one scale per row, and every key and value
rounded as a cache would store them.

This is the ``mistral`` family's reference (``families/mistral.py``).
Quest's plain pieces here (``_rope_tables``, ``_rope``, ``_attend``,
``_page_meta``, ``_page_select``, ``fp8_round``, ``Sequence_``) are
another family's too: its reference adds its own block and takes Quest's
selection from here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

LINEARS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_E4M3_MAX = 448.0


@dataclass(frozen=True)
class Shape:
    """The sizes the reference needs (plain values, no program types)."""

    hidden: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    eps: float
    rope_theta: float
    page: int
    budget_tokens: int
    skip_layers: int

    @property
    def group(self) -> int:
        return self.heads // self.kv_heads

    @property
    def budget_pages(self) -> int:
        return max(1, self.budget_tokens // self.page)


@dataclass
class Sequence_:
    """One request: ``tail`` follows the shared ``prefix`` in the prompt;
    ``served`` are the tokens the program returned for it. ``extra`` are
    further token ids, one a served position, whose logits are read too
    (the control's choices)."""

    tail: torch.Tensor
    served: torch.Tensor
    extra: Optional[torch.Tensor] = None


def fp8_round(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 and back to f32, scaled by the absolute
    maximum along ``dim`` (one scale per slice), or unscaled with
    ``dim=None`` (a cache's raw cast)."""
    if dim is None:
        return x.clamp(-_E4M3_MAX, _E4M3_MAX).to(torch.float8_e4m3fn).float()
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / _E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope_tables(positions: torch.Tensor, shape: Shape):
    d2 = shape.head_dim // 2
    inv = 1.0 / (shape.rope_theta ** (
        torch.arange(0, shape.head_dim, 2, dtype=torch.float64,
                     device=positions.device) / shape.head_dim))
    ang = positions.double()[:, None] * inv[None, :d2]
    return ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, mask, scale):
    """q [Tq, H, D], k/v [Tk, Hkv, D], mask [Hkv or 1, Tq, Tk] bool (True:
    attend). Returns [Tq, H, D]."""
    Tq, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qg = q.reshape(Tq, Hkv, G, D).permute(1, 2, 0, 3).reshape(Hkv, G * Tq, D)
    s = torch.bmm(qg, k.permute(1, 2, 0)).mul_(scale)       # [Hkv, G*Tq, Tk]
    s = s.view(Hkv, G, Tq, -1)
    s.masked_fill_(~mask[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1).view(Hkv, G * Tq, -1)
    o = torch.bmm(p, v.permute(1, 0, 2))                     # [Hkv, G*Tq, D]
    return o.view(Hkv, G, Tq, D).permute(2, 0, 1, 3).reshape(Tq, H, D)


def _page_meta(k_all, page: int):
    """Per-page element-wise (max, min) keys [P, Hkv, D] of ``k_all [S,
    Hkv, D]``; a last, partial page over its real tokens."""
    S, Hkv, D = k_all.shape
    P = -(-S // page)
    kp = torch.nn.functional.pad(k_all, (0, 0, 0, 0, 0, P * page - S))
    kp = kp.view(P, page, Hkv, D)
    tok = torch.arange(P * page, device=k_all.device).view(P, page)
    real = (tok < S)[:, :, None, None]
    return (torch.where(real, kp, float("-inf")).amax(1),
            torch.where(real, kp, float("inf")).amin(1))


def _page_select(q_dec, meta, t_dec, shape: Shape):
    """Selected pages [n, Hkv, P] (bool) of decode queries ``q_dec [n, H,
    D]`` at positions ``t_dec [n]``, from the pages' (max, min) keys."""
    page, K = shape.page, shape.budget_pages
    kmax, kmin = meta
    P, Hkv, D = kmax.shape
    n = q_dec.shape[0]
    qg = q_dec.view(n, Hkv, shape.group, D)
    qpos = qg.clamp(min=0).sum(2)                              # [n, Hkv, D]
    qneg = qg.clamp(max=0).sum(2)
    score = (torch.einsum("nkd,pkd->nkp", qpos, kmax)
             + torch.einsum("nkd,pkd->nkp", qneg, kmin))
    n_pages = t_dec // page + 1                                # [n]
    pid = torch.arange(P, device=kmax.device)
    cand = pid[None, :] < (n_pages - 1)[:, None]               # [n, P]
    score = score.masked_fill(~cand[:, None, :], float("-inf"))
    keep = min(K - 1, P)
    sel = torch.zeros((n, Hkv, P), dtype=torch.bool, device=kmax.device)
    if keep > 0:
        top = score.topk(keep, dim=-1)
        sel.scatter_(-1, top.indices, torch.isfinite(top.values))
    last = (pid[None, :] == (n_pages - 1)[:, None])[:, None, :]
    dense = (n_pages <= K)[:, None, None] & (pid[None, None, :]
                                              < n_pages[:, None, None])
    return sel | last | dense


@torch.no_grad()
def forward_logits(weights: Dict, shape: Shape, prefix: torch.Tensor,
                   seqs: Sequence[Sequence_], low_precision: bool = False,
                   block: int = 512, row_block: int = 8192) -> List[Dict]:
    """Run the reference over ``prefix + seq.tail + seq.served[:-1]`` for
    every ``seq`` (the prefix computed once), and return, for each, the
    logits read at the positions where each served token was chosen: the
    prompt's last position, then each fed-back token's. Each entry is a
    dict of [n] tensors: ``best`` (the largest logit), ``second`` (the
    next largest), ``served`` (the
    served token's logit), ``top`` (the argmax id) and, where ``extra``
    was given, ``extra`` (the logit of that id)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = weights["embed"].device
    L = weights["layers"]
    H, Hkv, D = shape.heads, shape.kv_heads, shape.head_dim
    scale = 1.0 / math.sqrt(D)
    S = int(prefix.numel())

    def wmat(t):
        w = t.float()
        return fp8_round(w, dim=0) if low_precision else w

    def kv_round(t):
        return fp8_round(t) if low_precision else t

    def act(t):
        return fp8_round(t, dim=-1) if low_precision else t

    def embed(t):
        rows = weights["embed"][t].float()
        return fp8_round(rows, dim=-1) if low_precision else rows

    x_pre = (embed(prefix.long().to(dev)) if S else
             torch.zeros((0, shape.hidden), device=dev))
    toks = [torch.cat([s.tail.long(), s.served.long()[:-1]]).to(dev)
            for s in seqs]
    xs = [embed(t) for t in toks]
    pos_pre = torch.arange(S, device=dev)
    rope_pre = _rope_tables(pos_pre, shape)
    pos = [S + torch.arange(t.numel(), device=dev) for t in toks]
    ropes = [_rope_tables(p, shape) for p in pos]
    n_tail = [int(s.tail.numel()) for s in seqs]

    def qkv(x, l, rope):
        h = act(_rms(x, L["ln_attn"][l].float(), shape.eps))
        q = (h @ W["wq"]).view(-1, H, D)
        k = (h @ W["wk"]).view(-1, Hkv, D)
        v = (h @ W["wv"]).view(-1, Hkv, D)
        return _rope(q, *rope), kv_round(_rope(k, *rope)), kv_round(v)

    def mlp_add(x, attn):
        x = x + act(attn.reshape(x.shape[0], H * D)) @ W["wo"]
        for r0 in range(0, x.shape[0], row_block):
            xr = x[r0:r0 + row_block]
            h = act(_rms(xr, L["ln_mlp"][l].float(), shape.eps))
            g = h @ W["w_gate"]
            xr += act(torch.nn.functional.silu(g) * (h @ W["w_up"])) \
                @ W["w_down"]
        return x

    for l in range(shape.layers):
        W = {k: wmat(L[k][l]) for k in LINEARS}
        sparse = l >= shape.skip_layers
        # The shared prefix: dense causal attention in query blocks.
        if S:
            k_pre = torch.empty((S, Hkv, D), device=dev)
            v_pre = torch.empty((S, Hkv, D), device=dev)
            q_pre = torch.empty((S, H, D), device=dev)
            for r0 in range(0, S, row_block):
                r1 = min(S, r0 + row_block)
                rope = (rope_pre[0][r0:r1], rope_pre[1][r0:r1])
                q_pre[r0:r1], k_pre[r0:r1], v_pre[r0:r1] = qkv(
                    x_pre[r0:r1], l, rope)
            attn = torch.empty((S, H, D), device=dev)
            for b0 in range(0, S, block):
                b1 = min(S, b0 + block)
                kpos = torch.arange(b1, device=dev)
                qpos = torch.arange(b0, b1, device=dev)
                mask = (kpos[None, :] <= qpos[:, None])[None]
                attn[b0:b1] = _attend(q_pre[b0:b1], k_pre[:b1], v_pre[:b1],
                                      mask, scale)
            del q_pre
        else:
            k_pre = v_pre = torch.zeros((0, Hkv, D), device=dev)
        # Each request's own tokens over the prefix and themselves.
        new_xs = []
        for i, x in enumerate(xs):
            q, k, v = qkv(x, l, ropes[i])
            k_all = torch.cat([k_pre, k])
            v_all = torch.cat([v_pre, v])
            t_all = pos[i]
            out = torch.empty_like(q)
            kpos = torch.arange(k_all.shape[0], device=dev)
            meta = _page_meta(k_all, shape.page) if sparse else None
            for b0 in range(0, q.shape[0], 128):
                b1 = min(q.shape[0], b0 + 128)
                t = t_all[b0:b1]
                causal = kpos[None, :] <= t[:, None]            # [n, Tk]
                mask = causal[None].expand(Hkv, -1, -1)
                dec = torch.arange(b0, b1, device=dev) >= n_tail[i]
                if sparse and bool(dec.any()):
                    sel = _page_select(q[b0:b1][dec], meta, t[dec], shape)
                    tok_sel = sel[:, :, kpos // shape.page]     # [n', Hkv, Tk]
                    mask = mask.clone()
                    mask[:, dec] &= tok_sel.permute(1, 0, 2)
                out[b0:b1] = _attend(q[b0:b1], k_all, v_all, mask, scale)
            new_xs.append(mlp_add(x, out))
            del k_all, v_all
        xs = new_xs
        if S:
            x_pre = mlp_add(x_pre, attn)
            del attn
        del k_pre, v_pre, W
    head = wmat(weights["lm_head"])
    fnorm = weights["final_norm"].float()
    results = []
    for i, s in enumerate(seqs):
        xr = xs[i][n_tail[i] - 1:]
        logits = act(_rms(xr, fnorm, shape.eps)) @ head        # [n, V]
        served = s.served.long().to(dev)
        top2 = logits.topk(2, dim=-1)
        res = dict(best=top2.values[:, 0], second=top2.values[:, 1],
                   served=logits.gather(1, served[:, None])[:, 0],
                   top=top2.indices[:, 0])
        if s.extra is not None:
            res["extra"] = logits.gather(
                1, s.extra.long().to(dev)[:, None])[:, 0]
        results.append(res)
    return results
