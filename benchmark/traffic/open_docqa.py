"""Open-loop questions over shared long documents: requests arrive as a
Poisson process at ``rate_per_s``; each picks one of ``docs`` documents
of ``doc_tokens`` tokens uniformly, asks a question of
``question_tokens`` tokens and takes a greedy answer of
``answer_tokens`` tokens (no end token).

The documents are prefilled in set-up (one request each: the document
and a question of the shortest length, one token answered), which
publishes them in the prefix cache; a second request a document, with
the longest question and a ``burst + 1``-token answer, warms the
question's prefill bucket and the captured decode step.

Sizes and arrivals: the arrival times (one Poisson schedule, its gaps
scaled so that exactly ``rate_per_s`` times the window's seconds fall in
the window), the
documents picked and the question and answer lengths come from
``lengths_seed``, the same for every run, as a replayed trace; the
run's seed deals the requests to the arrival times in another order
within blocks of ``block`` consecutive arrivals, and draws every token
id and the documents."""

from __future__ import annotations

import math

import numpy as np

from bench.mix import Req, Traffic, block_permutation, lengths, tokens


def make(p: dict, vocab: int, seed: int, seconds: float) -> Traffic:
    rng = np.random.default_rng(seed)
    sizes = np.random.default_rng(p["lengths_seed"])
    rate, n_docs, blk = p["rate_per_s"], p["docs"], p["block"]
    docs = [tokens(rng, vocab, p["doc_tokens"]) for _ in range(n_docs)]
    n = int(math.ceil(rate * seconds * 1.5)) + 2 * blk
    gaps = sizes.exponential(1.0, size=n)
    m = int(round(rate * seconds))
    # Exactly m arrivals in the window: the (m + 1)-th is due at its end.
    gaps *= seconds / (np.cumsum(gaps)[m] - gaps[0])
    doc = sizes.integers(0, n_docs, size=n)
    qlo, qhi = p["question_tokens"]
    alo, ahi = p["answer_tokens"]
    q = lengths(sizes, qlo, qhi, n, p["question_dist"])
    a = lengths(sizes, alo, ahi, n, p["answer_dist"])
    order = block_permutation(n, blk, rng)
    due = np.cumsum(gaps) - gaps[0]
    due[m] = seconds        # exactly, whatever the scaling rounded to
    arrivals = [(float(t), Req(int(doc[i]), tokens(rng, vocab, q[i]),
                               int(a[i])))
                for t, i in zip(due, order)]
    burst = p["engine"]["burst"]
    return Traffic(
        docs=docs,
        setup=[Req(d, tokens(rng, vocab, qlo), 1) for d in range(n_docs)],
        warm=[Req(d, tokens(rng, vocab, qhi), burst + 1)
              for d in range(n_docs)],
        arrivals=arrivals, engine=dict(p["engine"]), check=dict(p["check"]),
        drain_s=p["drain_s"], trace_ticks=p["trace_ticks"])
