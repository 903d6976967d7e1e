"""LongBench prediction harness (counterpart of
``quest_tpu/evals/longbench.py``).

As the reference's ``evaluation/LongBench/pred.py``: per-task prompt
templates, middle truncation of over-long prompts, the context
prefilled and the question decoded token by token so Quest's sparsity
applies to the question and answer tokens, jsonl predictions, and
``eval.py``-style scoring (``longbench_metrics.py``). The prompt and
length tables are byte-identical copies of the JAX package's.

Dataset jsonl files must be available locally; pass their directory as
``data_dir``. Each line: {"input", "context", "answers", "all_classes",
...} following the LongBench schema.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from quest_tpu_torch.engine.engine import QuestEngine
from quest_tpu_torch.evals.longbench_metrics import score_task

# Per-task prompt formats + generation lengths — all 21 LongBench tasks,
# verbatim from the benchmark's config (changing a prompt changes the
# benchmark, so strings are kept byte-identical, including upstream's
# "asconcisely" typo in narrativeqa):
# (the reference's `evaluation/LongBench/config/dataset2prompt.json`
# and `dataset2maxlen.json`).
TASK_PROMPTS: Dict[str, str] = {
    "narrativeqa": "You are given a story, which can be either a novel or a movie script, and a question. Answer the question asconcisely as you can, using a single phrase if possible. Do not provide any explanation.\n\nStory: {context}\n\nNow, answer the question based on the story asconcisely as you can, using a single phrase if possible. Do not provide any explanation.\n\nQuestion: {input}\n\nAnswer:",
    "qasper": "You are given a scientific article and a question. Answer the question as concisely as you can, using a single phrase or sentence if possible. If the question cannot be answered based on the information in the article, write \"unanswerable\". If the question is a yes/no question, answer \"yes\", \"no\", or \"unanswerable\". Do not provide any explanation.\n\nArticle: {context}\n\n Answer the question based on the above article as concisely as you can, using a single phrase or sentence if possible. If the question cannot be answered based on the information in the article, write \"unanswerable\". If the question is a yes/no question, answer \"yes\", \"no\", or \"unanswerable\". Do not provide any explanation.\n\nQuestion: {input}\n\nAnswer:",
    "multifieldqa_en": "Read the following text and answer briefly.\n\n{context}\n\nNow, answer the following question based on the above text, only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "multifieldqa_zh": "阅读以下文字并用中文简短回答：\n\n{context}\n\n现在请基于上面的文章回答下面的问题，只告诉我答案，不要输出任何其他字词。\n\n问题：{input}\n回答：",
    "hotpotqa": "Answer the question based on the given passages. Only give me the answer and do not output any other words.\n\nThe following are given passages.\n{context}\n\nAnswer the question based on the given passages. Only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "2wikimqa": "Answer the question based on the given passages. Only give me the answer and do not output any other words.\n\nThe following are given passages.\n{context}\n\nAnswer the question based on the given passages. Only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "musique": "Answer the question based on the given passages. Only give me the answer and do not output any other words.\n\nThe following are given passages.\n{context}\n\nAnswer the question based on the given passages. Only give me the answer and do not output any other words.\n\nQuestion: {input}\nAnswer:",
    "dureader": "请基于给定的文章回答下述问题。\n\n文章：{context}\n\n请基于上述文章回答下面的问题。\n\n问题：{input}\n回答：",
    "gov_report": "You are given a report by a government agency. Write a one-page summary of the report.\n\nReport:\n{context}\n\nNow, write a one-page summary of the report.\n\nSummary:",
    "qmsum": "You are given a meeting transcript and a query containing a question or instruction. Answer the query in one or more sentences.\n\nTranscript:\n{context}\n\nNow, answer the query based on the above meeting transcript in one or more sentences.\n\nQuery: {input}\nAnswer:",
    "multi_news": "You are given several news passages. Write a one-page summary of all news. \n\nNews:\n{context}\n\nNow, write a one-page summary of all the news.\n\nSummary:",
    "vcsum": "下面有一段会议记录，请你阅读后，写一段总结，总结会议的内容。\n会议记录：\n{context}\n\n会议总结：",
    "trec": "Please determine the type of the question below. Here are some examples of questions.\n\n{context}\n{input}",
    "triviaqa": "Answer the question based on the given passage. Only give me the answer and do not output any other words. The following are some examples.\n\n{context}\n\n{input}",
    "samsum": "Summarize the dialogue into a few short sentences. The following are some examples.\n\n{context}\n\n{input}",
    "lsht": "请判断给定新闻的类别，下面是一些例子。\n\n{context}\n{input}",
    "passage_count": "There are some paragraphs below sourced from Wikipedia. Some of them may be duplicates. Please carefully read these paragraphs and determine how many unique paragraphs there are after removing duplicates. In other words, how many non-repeating paragraphs are there in total?\n\n{context}\n\nPlease enter the final count of unique paragraphs after removing duplicates. The output format should only contain the number, such as 1, 2, 3, and so on.\n\nThe final answer is: ",
    "passage_retrieval_en": "Here are 30 paragraphs from Wikipedia, along with an abstract. Please determine which paragraph the abstract is from.\n\n{context}\n\nThe following is an abstract.\n\n{input}\n\nPlease enter the number of the paragraph that the abstract is from. The answer format must be like \"Paragraph 1\", \"Paragraph 2\", etc.\n\nThe answer is: ",
    "passage_retrieval_zh": "以下是若干段落文字，以及其中一个段落的摘要。请确定给定的摘要出自哪一段。\n\n{context}\n\n下面是一个摘要\n\n{input}\n\n请输入摘要所属段落的编号。答案格式必须是\"段落1\"，\"段落2\"等格式\n\n答案是：",
    "lcc": "Please complete the code given below. \n{context}Next line of code:\n",
    "repobench-p": "Please complete the code given below. \n{context}{input}Next line of code:\n",
}

TASK_MAXLEN: Dict[str, int] = {
    "narrativeqa": 128, "qasper": 128, "multifieldqa_en": 64,
    "multifieldqa_zh": 64, "hotpotqa": 32, "2wikimqa": 32,
    "musique": 32, "dureader": 128, "gov_report": 512, "qmsum": 512,
    "multi_news": 512, "vcsum": 512, "trec": 64, "triviaqa": 32,
    "samsum": 128, "lsht": 64, "passage_count": 32,
    "passage_retrieval_en": 32, "passage_retrieval_zh": 32,
    "lcc": 64, "repobench-p": 64,
}


def truncate_middle(tokenizer, prompt: str, max_length: int) -> str:
    """LongBench truncation: keep head+tail halves (`pred.py`)."""
    ids = tokenizer.encode(prompt)
    if len(ids) <= max_length:
        return prompt
    half = max_length // 2
    return (tokenizer.decode(ids[:half], skip_special_tokens=True)
            + tokenizer.decode(ids[-half:], skip_special_tokens=True))


def predict_task(engine: QuestEngine, tokenizer, task: str,
                 samples: List[dict], max_prompt_len: int,
                 out_path: Optional[str] = None,
                 decode_question: bool = True) -> List[str]:
    """Generate predictions for one task's samples."""
    template = TASK_PROMPTS[task]
    gen_len = TASK_MAXLEN[task]
    preds: List[str] = []
    outf = open(out_path, "w") if out_path else None
    for sample in samples:
        prompt = template.format(**sample)
        prompt = truncate_middle(tokenizer, prompt, max_prompt_len)
        ids = tokenizer.encode(prompt)
        engine.clear()
        if decode_question and len(ids) > 64:
            # Prefill all but the final question tokens; decode those
            # token-by-token so sparsity is active (as `pred.py` does).
            # Question feed + greedy answer run as async on-device
            # bursts (no per-token host fetch); EOS is trimmed
            # host-side from the over-generated tail.
            split = len(ids) - 32
            engine.prefill([ids[:split]])
            engine.feed_ondevice([ids[split:-1]])
            out_ids = engine.greedy_ondevice([ids[-1]],
                                             gen_len)[0].tolist()
        else:
            logits = engine.prefill([ids])
            first = int(logits[0].argmax())
            out_ids = [first]
            if gen_len > 1:
                out_ids += engine.greedy_ondevice([first],
                                                  gen_len - 1)[0].tolist()
        eos = getattr(tokenizer, "eos_token_id", -1)
        if eos is not None and eos in out_ids:
            out_ids = out_ids[: out_ids.index(eos)]
        text = tokenizer.decode(out_ids, skip_special_tokens=True)
        preds.append(text)
        if outf:
            print(json.dumps({"pred": text,
                              "answers": sample.get("answers", []),
                              "all_classes": sample.get("all_classes", [])}),
                  file=outf, flush=True)
    if outf:
        outf.close()
    return preds


def load_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def evaluate_longbench(engine: QuestEngine, tokenizer, data_dir: str,
                       tasks: List[str], max_prompt_len: int,
                       out_dir: Optional[str] = None) -> Dict[str, float]:
    """Run predictions + scoring; returns {task: score}."""
    results: Dict[str, float] = {}
    for task in tasks:
        samples = load_jsonl(os.path.join(data_dir, f"{task}.jsonl"))
        out_path = (os.path.join(out_dir, f"{task}.jsonl")
                    if out_dir else None)
        preds = predict_task(engine, tokenizer, task, samples,
                             max_prompt_len, out_path)
        golds = [s.get("answers", [""]) for s in samples]
        classes = samples[0].get("all_classes", []) if samples else []
        results[task] = score_task(task, preds, golds, classes)
    return results
