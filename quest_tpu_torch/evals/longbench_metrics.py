"""LongBench scoring metrics, dependency-free (a copy of
``quest_tpu/evals/longbench_metrics.py``, which the port does not
import).

The LongBench reference's metrics (qa F1, rouge-L, classification,
retrieval, code similarity) without the `rouge`/`fuzzywuzzy` packages:
rouge-L and token-ratio similarity are implemented directly (LCS /
difflib); Chinese text is scored per character.
"""

from __future__ import annotations

import difflib
import re
import string
from collections import Counter
from typing import List


def normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


def _f1(pred_tokens: List[str], gold_tokens: List[str]) -> float:
    common = Counter(pred_tokens) & Counter(gold_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gold_tokens)
    return 2 * precision * recall / (precision + recall)


def qa_f1_score(prediction: str, ground_truth: str, **kw) -> float:
    p = normalize_answer(prediction).split()
    g = normalize_answer(ground_truth).split()
    if not p or not g:
        return 0.0
    return _f1(p, g)


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l_score(prediction: str, ground_truth: str, **kw) -> float:
    p = normalize_answer(prediction).split()
    g = normalize_answer(ground_truth).split()
    if not p or not g:
        return 0.0
    lcs = _lcs_len(p, g)
    if lcs == 0:
        return 0.0
    prec, rec = lcs / len(p), lcs / len(g)
    return 2 * prec * rec / (prec + rec)


def classification_score(prediction: str, ground_truth: str,
                         all_classes: List[str] = (), **kw) -> float:
    em_match_list = [c for c in all_classes
                     if c in prediction and c != ""]
    # drop classes that are substrings of the gold label but not it
    em_match_list = [c for c in em_match_list
                     if not (c in ground_truth and c != ground_truth)]
    if ground_truth in em_match_list:
        return 1.0 / len(em_match_list)
    return 0.0


def retrieval_score(prediction: str, ground_truth: str, **kw) -> float:
    """Fraction of the numbers in the prediction equal to the gold
    paragraph id (the benchmark's semantics, the reference's
    `evaluation/LongBench/metrics.py:56-66` — NOT binary membership,
    which over-scores predictions that hedge by listing several
    paragraph numbers)."""
    m = re.search(r"Paragraph (\d+)", ground_truth)
    gold = m.group(1) if m else normalize_answer(ground_truth)
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    return sum(1 for n in numbers if n == gold) / len(numbers)


def count_score(prediction: str, ground_truth: str, **kw) -> float:
    """Reference `eval.py` count_score: fraction of the numbers in the
    prediction equal to the gold count."""
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    right = sum(1 for n in numbers if str(n) == str(ground_truth))
    return right / len(numbers)


def _zh_chars(s: str) -> List[str]:
    """Character-level tokens for Chinese text: the reference segments
    with jieba (`metrics.py`); a dependency-free build uses per-character
    tokens, which the LongBench authors note is a close proxy for
    CJK F1/rouge. Whitespace and punctuation are dropped."""
    s = re.sub(r"\s+", "", s.lower())
    drop = set(string.punctuation) | set("，。？！；：""''（）《》、…—·")
    return [ch for ch in s if ch not in drop]


def qa_f1_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    p, g = _zh_chars(prediction), _zh_chars(ground_truth)
    if not p or not g:
        return 0.0
    return _f1(p, g)


def rouge_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    p, g = _zh_chars(prediction), _zh_chars(ground_truth)
    if not p or not g:
        return 0.0
    lcs = _lcs_len(p, g)
    if lcs == 0:
        return 0.0
    prec, rec = lcs / len(p), lcs / len(g)
    return 2 * prec * rec / (prec + rec)


def retrieval_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    """Fraction semantics — see retrieval_score
    (the reference's `evaluation/LongBench/metrics.py:68-78`)."""
    m = re.search(r"段落(\d+)", ground_truth)
    gold = m.group(1) if m else normalize_answer(ground_truth)
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    return sum(1 for n in numbers if n == gold) / len(numbers)


def code_sim_score(prediction: str, ground_truth: str, **kw) -> float:
    all_lines = prediction.lstrip("\n").split("\n")
    pred = ""
    for line in all_lines:
        if ("`" not in line and "#" not in line and "//" not in line
                and line.strip()):
            pred = line
            break
    return difflib.SequenceMatcher(None, pred, ground_truth).ratio()


TASK_METRICS = {
    # task -> metric fn (the reference's `evaluation/LongBench/eval.py:18-40`)
    "narrativeqa": qa_f1_score,
    "qasper": qa_f1_score,
    "multifieldqa_en": qa_f1_score,
    "hotpotqa": qa_f1_score,
    "2wikimqa": qa_f1_score,
    "musique": qa_f1_score,
    "gov_report": rouge_l_score,
    "qmsum": rouge_l_score,
    "multi_news": rouge_l_score,
    "triviaqa": qa_f1_score,
    "samsum": rouge_l_score,
    "trec": classification_score,
    "passage_retrieval_en": retrieval_score,
    "passage_count": count_score,
    "lcc": code_sim_score,
    "repobench-p": code_sim_score,
    # Chinese tasks (char-level, see _zh_chars)
    "multifieldqa_zh": qa_f1_zh_score,
    "dureader": rouge_zh_score,
    "vcsum": rouge_zh_score,
    "lsht": classification_score,
    "passage_retrieval_zh": retrieval_zh_score,
}


def score_task(task: str, predictions: List[str],
               ground_truths: List[List[str]],
               all_classes: List[str] = ()) -> float:
    metric = TASK_METRICS[task]
    total = 0.0
    for pred, golds in zip(predictions, ground_truths):
        total += max(metric(pred, g, all_classes=all_classes)
                     for g in golds)
    return 100.0 * total / max(len(predictions), 1)
