"""Closed-loop questions over long documents: ``clients`` clients and as
many resident documents of ``doc_tokens`` tokens; the clients ask
question after question (``question_tokens`` long, answers of
``answer_tokens``, greedy, no end token) with no think time, client c's
r-th about document (c + r) mod ``clients``. The scheduler gives a
client's next request the slot its last one freed, so a client keeps a
slot; moving each client through the documents makes every document's
requests pass through every slot, and a check of one document's answers
covers the whole batch.

The documents are prefilled in set-up as each client's first request
(its document and a question of the shortest length, one token
answered), which publishes them in the prefix cache; a second request a
client, with the longest question and a ``burst + 1``-token answer,
warms the question's prefill bucket and the captured decode step.

Sizes: the question and answer lengths of round r (every client's r-th
request) come from ``lengths_seed``, the same for every run; the run's
seed deals them to the clients in another order and draws every token
id and the documents."""

from __future__ import annotations

import numpy as np

from bench.mix import Req, Traffic, lengths, tokens


def make(p: dict, vocab: int, seed: int, seconds: float) -> Traffic:
    rng = np.random.default_rng(seed)
    sizes = np.random.default_rng(p["lengths_seed"])
    C, rounds = p["clients"], p["rounds"]
    qlo, qhi = p["question_tokens"]
    alo, ahi = p["answer_tokens"]
    q = lengths(sizes, qlo, qhi, C * rounds, p["question_dist"])
    a = lengths(sizes, alo, ahi, C * rounds, p["answer_dist"])
    docs = [tokens(rng, vocab, p["doc_tokens"]) for _ in range(C)]
    clients = [[] for _ in range(C)]
    for r in range(rounds):
        for c, i in enumerate(r * C + rng.permutation(C)):
            clients[c].append(Req((c + r) % C, tokens(rng, vocab, q[i]),
                                  int(a[i])))
    burst = p["engine"]["burst"]
    return Traffic(
        docs=docs,
        setup=[Req(c, tokens(rng, vocab, qlo), 1) for c in range(C)],
        warm=[Req(c, tokens(rng, vocab, qhi), burst + 1) for c in range(C)],
        clients=clients, engine=dict(p["engine"]), check=dict(p["check"]),
        drain_s=p["drain_s"], trace_ticks=p["trace_ticks"])
