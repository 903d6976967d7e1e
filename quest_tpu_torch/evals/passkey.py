"""Passkey retrieval evaluation (counterpart of
``quest_tpu/evals/passkey.py``).

As the reference's ``evaluation/passkey/passkey.py``: a
landmark-attention-style prompt hides a random 5-digit passkey inside
filler text at a chosen depth; the harness prefills the context, feeds
the question token by token as *decode* steps so Quest's sparsity
applies, generates the answer greedily and checks the digits. Prompts
come from Python's ``random`` seeded as in JAX, so both packages build
the same strings.
"""

from __future__ import annotations

import random
import re
from dataclasses import dataclass
from typing import List, Optional

from quest_tpu_torch.engine.engine import QuestEngine


def build_passkey_prompt(n_garbage: int, seed: int,
                         depth_ratio: Optional[float] = None):
    """Returns (context_str, question_str, passkey_str).

    Structure follows the reference generator: task description,
    filler repeated, the passkey line at a chosen depth, more filler,
    then the retrieval question.
    """
    rng = random.Random(seed)
    n_garbage_prefix = int(n_garbage * (depth_ratio if depth_ratio
                                        is not None else rng.random()))
    n_garbage_suffix = n_garbage - n_garbage_prefix

    task = ("There is an important info hidden inside a lot of irrelevant "
            "text. Find it and memorize them. I will quiz you about the "
            "important information there.")
    garbage = ("The grass is green. The sky is blue. The sun is yellow. "
               "Here we go. There and back again. ")
    garbage_prefix = garbage * (n_garbage_prefix // len(garbage) + 1)
    garbage_prefix = garbage_prefix[:n_garbage_prefix]
    garbage_suffix = garbage * (n_garbage_suffix // len(garbage) + 1)
    garbage_suffix = garbage_suffix[:n_garbage_suffix]
    passkey = str(rng.randint(10000, 99999))
    info = (f"The pass key is {passkey}. Remember it. "
            f"{passkey} is the pass key.")
    question = "What is the pass key? The pass key is"
    context = "\n".join([task, garbage_prefix, info, garbage_suffix])
    return context, question, passkey


@dataclass
class PasskeyResult:
    correct: int
    total: int
    per_depth: dict

    @property
    def accuracy(self) -> float:
        return self.correct / max(self.total, 1)


def evaluate_passkey(engine: QuestEngine, tokenizer, n_garbage: int = 60000,
                     iterations: int = 20, max_new_tokens: int = 8,
                     depth_ratios: Optional[List[float]] = None,
                     seed: int = 0) -> PasskeyResult:
    """Run the retrieval protocol: prefill context, decode question
    token-by-token (sparsity active), generate and grade the answer."""
    depths = depth_ratios or [i / 10 for i in range(10)]
    per_depth = {d: [0, 0] for d in depths}
    correct = total = 0
    it = 0
    for d in depths:
        for rep in range(max(1, iterations // len(depths))):
            context, question, passkey = build_passkey_prompt(
                n_garbage, seed=seed * 1000 + it, depth_ratio=d)
            it += 1
            engine.clear()
            ctx_ids = tokenizer.encode(context)
            try:
                q_ids = tokenizer.encode(question, add_special_tokens=False)
            except TypeError:  # tokenizer without the kwarg
                q_ids = tokenizer.encode(question)
            engine.prefill([ctx_ids])
            # Question fed token-by-token as decode (as the reference),
            # then the answer generated greedily — both as async
            # on-device bursts with no per-token host fetch.
            if len(q_ids) > 1:
                engine.feed_ondevice([q_ids[:-1]])
            out_ids = engine.greedy_ondevice([q_ids[-1]],
                                             max_new_tokens)[0].tolist()
            answer = tokenizer.decode(out_ids)
            digits = re.findall(r"\d+", answer)
            ok = any(passkey in dd for dd in digits) or passkey in answer
            correct += int(ok)
            total += 1
            per_depth[d][0] += int(ok)
            per_depth[d][1] += 1
    return PasskeyResult(correct, total,
                         {d: c / max(n, 1) for d, (c, n) in per_depth.items()})
