"""Token-by-token perplexity evaluation, PG19 protocol (counterpart of
``quest_tpu/evals/perplexity.py``).

As the reference's ``evaluation/pg19/ppl_eval.py``: the text is fed one
token at a time in *decode* mode so Quest's sparsity is live for every
prediction, the NLLs are accumulated and exp(mean NLL) is reported; the
per-token log is written as the reference writes it. The first
prediction comes from the prefill's logits, every later one from the
engine's on-device teacher-forced burst (``QuestEngine.score_ondevice``).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from quest_tpu_torch.engine.engine import QuestEngine


def evaluate_perplexity(engine: QuestEngine, token_ids: List[int],
                        num_eval_tokens: Optional[int] = None,
                        log_path: Optional[str] = None,
                        warmup_prefill: int = 1) -> float:
    """NLL/perplexity of `token_ids` under the engine's Quest config.

    ``warmup_prefill`` tokens seed the cache via prefill (>=1 so decode
    has context); every following token is predicted in decode mode.
    """
    engine.clear()
    ids = list(token_ids)
    if num_eval_tokens is not None:
        ids = ids[: num_eval_tokens + warmup_prefill]
    if len(ids) < warmup_prefill + 1:
        raise ValueError(f"{len(ids)} tokens: need more than "
                         f"warmup_prefill={warmup_prefill}")

    logits = engine.prefill([ids[:warmup_prefill]])  # [B, V]
    # First prediction comes from the prefill logits; every later one
    # rides the on-device teacher-forced burst (async decode_nll_step
    # chain, NLLs fetched in bulk) — same protocol as the reference's
    # per-token loop at serving speed instead of a [B, V] logits fetch
    # per token.
    nlls: List[float] = [-_log_softmax_at(logits[0], ids[warmup_prefill])]
    if len(ids) > warmup_prefill + 1:
        feed = np.asarray([ids[warmup_prefill:-1]], np.int32)
        targets = np.asarray([ids[warmup_prefill + 1:]], np.int32)
        nlls.extend(engine.score_ondevice(feed, targets)[0].tolist())

    if log_path:
        with open(log_path, "w") as logf:
            for v in nlls:
                print(v, file=logf)
    return float(math.exp(np.mean(nlls)))


def _log_softmax_at(logits: np.ndarray, idx: int) -> float:
    m = float(logits.max())
    lse = m + math.log(float(np.exp(logits - m).sum()))
    return float(logits[idx]) - lse
