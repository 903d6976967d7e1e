"""The port's eval harnesses against the JAX package's, on the CPU:
``score_task`` equal on all 21 LongBench tasks, the prompt and length
tables equal, ``quest_sim_attention`` within 1e-5 (f32), perplexity
within 1e-4 relative on a tiny f32 model with the sparse path live, the
passkey prompts identical and ``evaluate_passkey`` with the same result
and generated ids, ``predict_task`` / ``evaluate_longbench`` with the
same predictions (middle truncation exercised); and the three launchers
run in-process with ``--random --preset tiny --device cpu``."""

import dataclasses
import json
import math
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from quest_tpu_torch.config import (ModelConfig, QuestConfig, RopeConfig,
                                    tiny_test_model)
from quest_tpu_torch.engine import QuestEngine
from quest_tpu_torch.evals import (build_passkey_prompt, evaluate_longbench,
                                   evaluate_passkey, evaluate_perplexity,
                                   predict_task, quest_sim_attention,
                                   score_task)
from quest_tpu_torch.evals import longbench as tlb
from quest_tpu_torch.evals import longbench_metrics as tlm
from quest_tpu_torch.models.convert import params_from_numpy
from quest_tpu_torch.models.llama import init_params
from quest_tpu_torch.scripts import longbench as s_longbench
from quest_tpu_torch.scripts import passkey as s_passkey
from quest_tpu_torch.scripts import ppl_eval as s_ppl
from quest_tpu_torch.utils import cli

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the card's eval phase, run here small)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# tests/test_evals.py's tiny model, with a vocabulary that holds the
# byte tokenizer's ids.
MODEL = dict(vocab_size=259, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16)
QUEST = dict(page_size=16, token_budget=64, max_seq_len=2048, skip_layers=1)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from quest_tpu import config as jconfig
    from quest_tpu import evals as jevals
    from quest_tpu.engine.engine import QuestEngine as JEngine
    from quest_tpu.evals import longbench as jlb
    from quest_tpu.evals import longbench_metrics as jlm
    from quest_tpu.models.llama import init_params
    from quest_tpu.utils import cli as jcli
    jcfg = jconfig.ModelConfig(rope=jconfig.RopeConfig(), dtype=jnp.float32,
                               **MODEL)
    jquest = jconfig.QuestConfig(kv_dtype=jnp.float32, **QUEST)
    params = jax.tree.map(np.asarray, init_params(
        jcfg, jax.random.PRNGKey(0), dtype=jnp.float32))
    cfg = ModelConfig(rope=RopeConfig(), dtype=torch.float32, **MODEL)
    quest = QuestConfig(kv_dtype=torch.float32, **QUEST)

    def engines():
        return (JEngine(jcfg, jquest, params, batch_size=1, prefill_bucket=64),
                QuestEngine(cfg, quest, params_from_numpy(params, device="cpu"),
                            batch_size=1, prefill_bucket=64, device="cpu"))

    return types.SimpleNamespace(jnp=jnp, jevals=jevals, jlb=jlb, jlm=jlm,
                                 jcli=jcli, engines=engines)


# -- LongBench scoring and tables --------------------------------------------

# Per task: predictions, each row's gold answers, and the classes (the
# classification tasks). English, Chinese and code; exact hits, partial
# overlaps, misses, hedged numbers and empty predictions.
_EN = (["Paris is the capital", "the cat sat", "", "42 apples"],
       [["Paris"], ["A cat sat down", "the dog"], ["anything"], ["41 apples"]])
_ZH = (["北京是中国的首都", "会议讨论了预算", "", "完全不同"],
       [["中国的首都是北京"], ["会议讨论了明年的预算"], ["答案"], ["毫无关联"]])
SCORE_TABLE = {
    **{t: _EN for t in ("narrativeqa", "qasper", "multifieldqa_en",
                        "hotpotqa", "2wikimqa", "musique", "triviaqa",
                        "gov_report", "qmsum", "multi_news", "samsum")},
    **{t: _ZH for t in ("multifieldqa_zh", "dureader", "vcsum")},
    "trec": (["Location", "Number and Description", "nothing"],
             [["Location"], ["Number"], ["Entity"]],
             ["Location", "Number", "Entity", "Description"]),
    "lsht": (["体育新闻", "财经与体育", "其他"],
             [["体育"], ["财经"], ["科技"]], ["体育", "财经", "科技"]),
    "passage_count": (["3", "There are 3 or 4", "none"],
                      [["3"], ["4"], ["2"]]),
    "passage_retrieval_en": (["Paragraph 7", "Paragraph 7 or 3", "no idea"],
                             [["Paragraph 7"], ["Paragraph 3"],
                              ["Paragraph 1"]]),
    "passage_retrieval_zh": (["答案是段落3", "段落3或段落5", "没有"],
                             [["段落3"], ["段落5"], ["段落1"]]),
    "lcc": (["    return x + 1\n", "# comment\nfoo(bar)", ""],
            [["    return x + 1"], ["foo(baz)"], ["pass"]]),
    "repobench-p": (["self.x = y", "```\nprint(a)", "z"],
                    [["self.x = y"], ["print(b)"], ["w = 1"]]),
}


@pytest.mark.parametrize("task", sorted(SCORE_TABLE))
def test_score_task_matches_jax(jx, task):
    preds, golds, *classes = SCORE_TABLE[task]
    classes = classes[0] if classes else []
    got = score_task(task, preds, golds, classes)
    assert got == jx.jlm.score_task(task, preds, golds, classes)
    assert 0.0 <= got <= 100.0


def test_task_tables_match_jax(jx):
    assert len(tlb.TASK_PROMPTS) == 21 == len(SCORE_TABLE)
    assert tlb.TASK_PROMPTS == jx.jlb.TASK_PROMPTS
    assert tlb.TASK_MAXLEN == jx.jlb.TASK_MAXLEN
    assert sorted(tlm.TASK_METRICS) == sorted(jx.jlm.TASK_METRICS)
    assert set(SCORE_TABLE) == set(tlb.TASK_PROMPTS)


# -- simulated attention -----------------------------------------------------

@pytest.mark.parametrize("T,budget,chunk", [(37, 10_000, 16), (200, 48, 16),
                                            (129, 64, 8), (64, 16, 16)])
def test_sim_attention_matches_jax(jx, T, budget, chunk):
    rng = np.random.default_rng(T + budget)
    B, H, D = 2, 3, 16
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, H, T, D)).astype(np.float32)
    v = rng.standard_normal((B, H, T, D)).astype(np.float32)
    sm = 1 / math.sqrt(D)
    want = np.asarray(jx.jevals.quest_sim_attention(
        jx.jnp.asarray(q), jx.jnp.asarray(k), jx.jnp.asarray(v), budget,
        chunk, sm))
    got = quest_sim_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), budget, chunk, sm)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -- perplexity and passkey ----------------------------------------------------

def test_evaluate_perplexity_matches_jax(jx, tmp_path):
    """100 prefilled tokens (7 pages over a 4-page budget: the sparse
    path is live), 40 predictions: within 1e-4 relative, and the same
    per-token log."""
    ids = np.random.default_rng(0).integers(3, 259, size=160).tolist()
    jeng, teng = jx.engines()
    want = jx.jevals.evaluate_perplexity(
        jeng, ids, num_eval_tokens=40, warmup_prefill=100,
        log_path=str(tmp_path / "j.txt"))
    got = evaluate_perplexity(teng, ids, num_eval_tokens=40,
                              warmup_prefill=100,
                              log_path=str(tmp_path / "t.txt"))
    assert math.isfinite(got) and abs(got - want) <= 1e-4 * want
    j = np.loadtxt(tmp_path / "j.txt")
    t = np.loadtxt(tmp_path / "t.txt")
    assert t.shape == j.shape == (40,)
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("depth", [None, 0.0, 0.3, 1.0])
def test_build_passkey_prompt_matches_jax(jx, depth):
    for seed in (0, 7, 1003):
        for n in (0, 50, 2000):
            assert (build_passkey_prompt(n, seed, depth)
                    == jx.jevals.build_passkey_prompt(n, seed, depth))


class _Recording:
    """A tokenizer that records every id list it decodes."""

    def __init__(self, tok):
        self.tok, self.decoded = tok, []
        self.eos_token_id = tok.eos_token_id

    def encode(self, *a, **kw):
        return self.tok.encode(*a, **kw)

    def decode(self, ids, **kw):
        self.decoded.append(list(ids))
        return self.tok.decode(ids, **kw)


def test_evaluate_passkey_matches_jax(jx):
    """Two depths, two prompts each of ~600 filler bytes (sparse path
    live), 6 new tokens: the same PasskeyResult and the same generated
    ids."""
    jeng, teng = jx.engines()
    jtok, ttok = _Recording(jx.jcli.ByteTokenizer()), _Recording(
        cli.ByteTokenizer())
    kw = dict(n_garbage=600, iterations=4, max_new_tokens=6,
              depth_ratios=[0.25, 0.75], seed=3)
    want = jx.jevals.evaluate_passkey(jeng, jtok, **kw)
    got = evaluate_passkey(teng, ttok, **kw)
    assert (got.correct, got.total, got.per_depth) == (
        want.correct, want.total, want.per_depth)
    assert got.total == 4 and ttok.decoded == jtok.decoded


def test_byte_tokenizer_matches_jax(jx):
    a, b = cli.ByteTokenizer(), jx.jcli.ByteTokenizer()
    for text in ("", "The pass key is 12345.", "段落3 — ok\n"):
        assert a.encode(text) == b.encode(text)
        assert a.encode(text, add_special_tokens=False) == b.encode(
            text, add_special_tokens=False)
        ids = a.encode(text) + [2, 0, 300]
        assert a.decode(ids) == b.decode(ids)
        assert a.decode(ids, skip_special_tokens=False) == b.decode(
            ids, skip_special_tokens=False)


# -- LongBench -----------------------------------------------------------------

def _samples():
    rng = np.random.default_rng(5)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    long_ctx = " ".join(rng.choice(words, size=120))
    return [
        {"context": long_ctx, "input": "Which word comes first?",
         "answers": ["alpha"], "all_classes": None},
        {"context": "short", "input": "?", "answers": ["beta"],
         "all_classes": None},
    ]


def test_predict_task_matches_jax(jx):
    """hotpotqa over a ~700-byte prompt truncated to 300 tokens (the
    question decoded token by token) and a prompt short enough for the
    prefill-only route: identical predictions; truncate_middle equal."""
    samples = _samples()
    ttok = cli.ByteTokenizer()
    prompt = tlb.TASK_PROMPTS["hotpotqa"].format(**samples[0])
    assert len(ttok.encode(prompt)) > 300
    cut = tlb.truncate_middle(ttok, prompt, 300)
    assert cut == jx.jlb.truncate_middle(jx.jcli.ByteTokenizer(), prompt, 300)
    assert len(ttok.encode(cut)) <= 301
    jeng, teng = jx.engines()
    want = jx.jlb.predict_task(jeng, jx.jcli.ByteTokenizer(), "hotpotqa",
                               samples, 300)
    got = predict_task(teng, ttok, "hotpotqa", samples, 300)
    assert got == want and len(got) == 2


def test_evaluate_longbench_matches_jax(jx, tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    for task in ("passage_count", "trec"):
        with open(data / f"{task}.jsonl", "w") as f:
            for s in _samples():
                s = dict(s, answers=["3"] if task == "passage_count"
                         else ["Location"],
                         all_classes=["Location", "Number"])
                print(json.dumps(s), file=f)
    jeng, teng = jx.engines()
    tasks = ["passage_count", "trec"]
    want = jx.jlb.evaluate_longbench(jeng, jx.jcli.ByteTokenizer(),
                                     str(data), tasks, 300)
    got = evaluate_longbench(teng, cli.ByteTokenizer(), str(data), tasks, 300,
                             out_dir=str(tmp_path))
    assert got == want
    lines = (tmp_path / "trec.jsonl").read_text().splitlines()
    assert [json.loads(l)["answers"] for l in lines] == [["Location"]] * 2


# -- the launchers ---------------------------------------------------------------

TINY = ["--random", "--preset", "tiny", "--device", "cpu", "--layers", "2"]


def test_ppl_eval_launcher_runs(tmp_path, capsys):
    out = tmp_path / "ppl"
    ppl = s_ppl.main(TINY + ["--num-eval-tokens", "24", "--output-dir",
                             str(out)])
    assert math.isfinite(ppl) and ppl > 1.0
    assert float((out / "ppl.txt").read_text()) == ppl
    assert len((out / "log.txt").read_text().split()) == 24
    assert "perplexity over 24 tokens" in capsys.readouterr().out


def test_passkey_launcher_runs(tmp_path, capsys):
    res = s_passkey.main(TINY + ["--n-garbage", "300", "--iterations", "10",
                                 "--max-new-tokens", "2", "--output",
                                 str(tmp_path / "pk.json")])
    assert res.total == 10
    saved = json.loads((tmp_path / "pk.json").read_text())
    assert saved["total"] == 10 and len(saved["per_depth"]) == 10
    assert "passkey accuracy" in capsys.readouterr().out


def test_longbench_launcher_runs(tmp_path, capsys):
    data = tmp_path / "data"
    data.mkdir()
    with open(data / "hotpotqa.jsonl", "w") as f:
        for s in _samples():
            print(json.dumps(s), file=f)
    res = s_longbench.main(TINY + ["--data-dir", str(data), "--tasks",
                                   "hotpotqa", "--max-prompt-len", "200",
                                   "--out-dir", str(tmp_path / "out")])
    assert set(res) == {"hotpotqa"} and 0.0 <= res["hotpotqa"] <= 100.0
    saved = json.loads((tmp_path / "out" / "result.json").read_text())
    assert saved == res
    assert '"hotpotqa"' in capsys.readouterr().out


def test_launchers_default_to_the_card():
    import argparse
    ap = argparse.ArgumentParser()
    cli.add_model_args(ap)
    args = ap.parse_args(["--random"])
    assert args.device == "cuda" and args.quantize == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.build_engine(args)


def test_cli_quantizes_the_engine():
    args = types.SimpleNamespace(
        model_path=None, random=True, preset="tiny", layers=1,
        token_budget=64, page_size=16, max_seq_len=256, skip_layers=1,
        batch=1, device="cpu", quantize=4)
    engine, tok = cli.build_engine(args)
    assert engine.model._bits == {k: 4 for k in (
        "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head")}
    out = engine.generate([tok.encode("hello")], max_new_tokens=3)
    assert len(out[0]) == 3


def test_chip_smoke_eval_phase_on_cpu():
    """chip_smoke.py's eval phase on the CPU's plain path at a tiny size:
    every harness completes, LongBench's prompts truncated to 300 tokens,
    with the decode steps each protocol takes."""
    cfg = dataclasses.replace(tiny_test_model(2), vocab_size=259,
                              num_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    res = chip_smoke.eval_phase(cfg, params, {}, device="cpu", warmup=100,
                                eval_tokens=8, n_garbage=300, lb_prompt=300)
    for label in ("sparse", "dense_control"):
        r = res[f"perplexity_{label}"]
        assert math.isfinite(r["ppl"]) and r["decode_steps"] == 7
    assert res["passkey"]["total"] == 2
    assert res["passkey"]["decode_steps"] == 2 * (37 - 1 + 8)
    lb = res["longbench"]
    assert lb["prefill_calls"] == 4 and lb["decode_steps"] == 4 * (31 + 32)
    assert set(lb["scores"]) == {"passage_count", "hotpotqa"}
