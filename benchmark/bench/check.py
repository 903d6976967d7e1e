"""Whether what the timed path produced is correct.

Once the window has closed: a sample, drawn from the seed, of the
requests due in the window that were answered: the longest of them
whole, and others over the same document, in an order drawn from the
seed, each with its first ``head_tokens`` served tokens, while the
tokens compared stay under ``max_checked_tokens``. The plain reference
of the configuration's family (``families/<model_type>.py:reference``,
computed in ``benchmark/reference``) runs once over each prompt with its
served tokens. At each served token's position its gap is how far its
logit lies below the reference's best there; the number compared is the
mean gap over the tokens compared. The widest gap is reported beside it,
not compared: on these random models bf16's and fp8's widest gaps lie
only 2.4-2.9x apart, their mean gaps 6-9x (PERF.md).

The control (``control=True``, for ``calibrate.py``; no run of the
benchmark computes it): the reference in fp8 at the same positions; the
numbers read are the mean and the widest gap, in the float32 reference,
of the token the fp8 reference puts first.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from reference.quest_ref import Sequence_


def sample(rec, seed: int, max_tokens: int,
           head_tokens: int) -> Tuple[Optional[int], List]:
    """(document, [(request, served tokens compared)]): the longest
    answered request whole, then others over its document in an order
    drawn from the seed, each with its first ``head_tokens`` served tokens
    (an answer's first tokens are its most varied), while the total stays
    under ``max_tokens``."""
    done = [st for st in rec.window_requests() if st.done
            and len(st.tokens) > 1]
    if not done:
        return None, []
    longest = max(done, key=lambda st: (len(st.tokens), -st.uid))
    doc = longest.req.doc
    rest = sorted((st for st in done
                   if st.req.doc == doc and st is not longest),
                  key=lambda st: st.uid)
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2 ** 63 - 1), 20]))
    picks, total = [(longest, list(longest.tokens))], len(longest.tokens)
    for i in rng.permutation(len(rest)):
        toks = rest[int(i)].tokens[:head_tokens]
        if total + len(toks) <= max_tokens:
            picks.append((rest[int(i)], list(toks)))
            total += len(toks)
    return doc, picks


def compare(reference: Callable, weights: Dict, dims: Dict, quest: Dict,
            prefix: np.ndarray, picks: List, control: bool = False) -> Dict:
    """``mean_gap`` and ``gap`` (the widest): how far the served tokens'
    logits lie below the best of ``reference`` (a family's), over
    ``picks``; ``tokens``: how many were compared; with ``control``, also
    ``control_mean_gap`` and ``control_gap``."""
    t = time.perf_counter()
    pre = torch.from_numpy(np.asarray(prefix, dtype=np.int64))
    seqs = [Sequence_(tail=torch.from_numpy(st.req.tail.astype(np.int64)),
                      served=torch.tensor(toks, dtype=torch.int64))
            for st, toks in picks]
    out = {}
    if control:
        low = reference(weights, dims, quest, pre, seqs, low_precision=True)
        for s, r in zip(seqs, low):
            s.extra = r["top"]
    res = reference(weights, dims, quest, pre, seqs)
    gaps = torch.cat([r["best"] - r["served"] for r in res])
    margin = torch.cat([r["best"] - r["second"] for r in res])
    out.update(gap=float(gaps.max()), mean_gap=float(gaps.mean()),
               tokens=int(gaps.numel()), mismatched=int((gaps > 0).sum()),
               near_ties=int((margin < 0.05).sum()),
               distinct=sum(len(set(toks)) for _, toks in picks))
    if control:
        cg = torch.cat([r["best"] - r["extra"] for r in res])
        out.update(control_gap=float(cg.max()),
                   control_mean_gap=float(cg.mean()),
                   control_mismatched=int((cg > 0).sum()))
    out["seconds"] = time.perf_counter() - t
    return out
