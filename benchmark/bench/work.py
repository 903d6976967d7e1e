"""The operations and bytes that a tick's inputs need, from its shapes
and lengths alone: the yardstick of the rooflines and of the model
steps' shares of the chip's peak.

Each input byte is counted once and each output byte once. Pages of a
document that several rows borrow from the prefix cache are one set of
bytes: the dense layers' keys and values and every sparse layer's page
metadata of a document are counted once a step, however many rows read
them. The pages a sparse layer selects depend on the queries, which the
host does not see, so they are counted for each row. Rows that ride
along in a tick without a token of their own (padding, idle slots,
prompts waiting for their chunk) need nothing and count nothing.

A decode row is ``(n, doc, uid)``: ``n`` tokens in the cache after the
step's append, ``doc`` the document it borrows (None: no shared prefix).
A row that finished earlier in its burst and decodes on only until the
burst ends (the host drops those tokens) needs nothing either.
A prefill row is ``(offset, n_new, doc, uid)``.

The counts here are those of a decoder whose every token reads every
linear weight, with Quest on every layer from ``skip_layers`` on. A
configuration's family (``families/<model_type>.py``, found from
``here``, the benchmark's folder) gives ``linear_params``, and its own
``decode_attention``, ``prefill_attention``, ``decode_step`` or
``prefill_tick`` where it defines one: the function here then returns
the family's count.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

from bench import manifest

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "float8_e4m3fn": 1}


def _family(dims: Dict, here):
    return manifest.family(dims["model_type"], here or manifest.HERE)


def _own(name: str, dims: Dict, here):
    """The family's function ``name``, or None where it defines none."""
    return getattr(_family(dims, here), name, None)


def _sizes(dims: Dict, quest: Dict):
    H, Hkv, D = (dims["num_attention_heads"], dims["num_key_value_heads"],
                 dims["head_dim"])
    return (H, Hkv, D, dims["num_hidden_layers"], quest["skip_layers"],
            quest["page_size"], max(1, quest["token_budget"]
                                    // quest["page_size"]),
            BYTES[quest["kv_dtype"]], BYTES[quest["meta_dtype"]])


def linear_params(dims: Dict, here=None) -> Tuple[int, int]:
    """(parameters of every layer's linears, of the head): the family's
    count."""
    return _family(dims, here).linear_params(dims)


def doc_tokens_of(rec) -> Dict:
    """Tokens of each document (the borrowed prefix)."""
    return {d: n for d, n in ((st.req.doc, st.doc_tokens)
                              for st in rec.requests.values())
            if d is not None}


def decode_attention(dims: Dict, quest: Dict, rows: Iterable[tuple],
                     doc_len: Dict, here=None) -> Tuple[float, float]:
    """(FLOPs, bytes) of one decode step's attention (estimate, top-k,
    sparse and dense decode) over ``rows``."""
    own = _own("decode_attention", dims, here)
    if own is not None:
        return own(dims, quest, rows, doc_len)
    H, Hkv, D, L, skip, page, K, kvb, mb = _sizes(dims, quest)
    tok_kv = Hkv * D * 2 * kvb          # one token's K and V, one layer
    page_meta = Hkv * D * 2 * mb        # one page's min and max, one layer
    flops = byt = 0.0
    docs: Dict = {}
    for n, doc, _ in rows:
        shared = min(doc_len.get(doc, 0), n) if doc is not None else 0
        if shared:
            docs[doc] = max(docs.get(doc, 0), shared)
        own = n - shared
        P = -(-n // page)
        own_pages = P - shared // page
        sel = n if P <= K else (K - 1) * page + (n - (P - 1) * page)
        byt += skip * own * tok_kv
        byt += (L - skip) * (own_pages * page_meta + sel * tok_kv)
        byt += L * H * D * (2 + 4)      # q in (bf16), output (f32)
        flops += skip * 4 * H * D * n
        flops += (L - skip) * (4 * H * D * P + 4 * H * D * sel)
    for shared in docs.values():
        byt += skip * shared * tok_kv
        byt += (L - skip) * (shared // page) * page_meta
    return flops, byt


def prefill_attention(dims: Dict, quest: Dict, rows: Iterable[tuple],
                      doc_len: Dict, here=None) -> Tuple[float, float]:
    """(FLOPs, bytes) of one prefill tick's causal attention: each row's
    ``n_new`` queries at positions ``offset ..`` over every earlier key."""
    own = _own("prefill_attention", dims, here)
    if own is not None:
        return own(dims, quest, rows, doc_len)
    H, Hkv, D, L, _, _, _, kvb, _ = _sizes(dims, quest)
    tok_kv = Hkv * D * 2 * kvb
    flops = byt = 0.0
    docs: Dict = {}
    for off, n_new, doc, _ in rows:
        if n_new <= 0:
            continue
        ctx = off + n_new
        shared = min(doc_len.get(doc, 0), off) if doc is not None else 0
        if shared:
            docs[doc] = max(docs.get(doc, 0), shared)
        # sum over queries i of (off + i + 1) keys
        keys = n_new * off + n_new * (n_new + 1) / 2
        flops += L * 4 * H * D * keys
        byt += L * ((ctx - shared) * tok_kv + n_new * H * D * (2 + 4))
    for shared in docs.values():
        byt += L * shared * tok_kv
    return flops, byt


def decode_step(dims: Dict, quest: Dict, rows, doc_len: Dict, here=None
                ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one whole decode step over ``rows``: every linear
    weight and the head read once, the attention's needs, each live row's
    appended K, V and page metadata, its embedding row, its logits."""
    own = _own("decode_step", dims, here)
    if own is not None:
        return own(dims, quest, rows, doc_len)
    rows = list(rows)
    H, Hkv, D, L, _, _, _, kvb, mb = _sizes(dims, quest)
    wb = BYTES[dims["torch_dtype"]]
    hid, V = dims["hidden_size"], dims["vocab_size"]
    lin, head = linear_params(dims, here)
    f_att, b_att = decode_attention(dims, quest, rows, doc_len, here)
    B = len(rows)
    flops = 2.0 * (lin + head) * B + f_att
    byt = ((lin + head) * wb + (2 * L + 1) * hid * wb + b_att
           + B * (hid * wb + V * 4 + L * Hkv * D * 2 * (kvb + mb)))
    return flops, byt


def prefill_tick(dims: Dict, quest: Dict, rows, doc_len: Dict,
                 here=None) -> float:
    """Model FLOPs of a prefill tick's real tokens: the linears of every
    real token, causal attention over each row's context, and the head of
    each row's last token."""
    own = _own("prefill_tick", dims, here)
    if own is not None:
        return own(dims, quest, rows, doc_len)
    lin, head = linear_params(dims, here)
    real = sum(max(0, r[1]) for r in rows)
    f_att, _ = prefill_attention(dims, quest, rows, doc_len, here)
    return 2.0 * lin * real + 2.0 * head * sum(1 for r in rows if r[1] > 0) \
        + f_att


def decode_steps_of(tick) -> list:
    """The needed rows of each decode step of a burst tick: step k of a
    row that held ``n0`` tokens before the burst has ``n0 + k + 1`` after
    its append; a row with ``left`` tokens still to serve needs only its
    first ``left`` steps."""
    return [[(n0 + k + 1, doc, uid) for n0, doc, uid, left in tick.decode_rows
             if k < left] for k in range(tick.steps)]
