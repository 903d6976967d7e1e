"""CPU tests of the architecture families (``benchmark/families``): the
``mistral`` family gives the weights, the port's model configuration,
the reference's logits and the work counts that the harness computed
before it had families (the literals below were read from that tree);
a configuration's ``model_type`` finds its family, an unknown one stops
the run, and a family that exists only in a copy of the benchmark is
found there without an edit of the harness."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import manifest, work
from conftest import TINY_CONFIG

HERE = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 12345

# Decode rows (n, doc, uid) and prefill rows (offset, n_new, doc, uid)
# over two documents: borrowed and own contexts, a row under the budget,
# a prefill row with nothing new.
DECODE = [(31944, 0, 1), (31944, 0, 2), (32000, 1, 3), (5000, None, 4),
          (1000, None, 5), (17, None, 6)]
PREFILL = [(31744, 256, 0, 1), (0, 200, None, 2), (4096, 0, 1, 3),
           (4096, 130, 1, 4), (8192, 8192, None, 5)]
DOCS = {0: 31744, 1: 4096}
COUNTS = {
    "mistral-7b-v0.3": dict(
        decode_step=(96348274688.0, 16477347840.0),
        prefill_tick=179880783773696.0,
        decode_attention=(10985799680.0, 2247327744.0),
        prefill_attention=(57350735527936.0, 13825212416.0)),
    "mistral-nemo-12b-2407": dict(
        decode_step=(151940235264.0, 25851828224.0),
        prefill_tick=263145310781440.0,
        decode_attention=(13024886784.0, 2693267456.0),
        prefill_attention=(71688419409920.0, 17281515520.0)),
}
# sha256 (first 16 hex digits) of each leaf's bf16 bits: the tiny
# configuration's weights at seed 3 on the CPU.
TINY_WEIGHTS = {
    "embed": "a4e77a5b420bde1f", "final_norm": "e72710531b01d91e",
    "lm_head": "071c92406d9293af", "layers.wq": "252709f019c473fb",
    "layers.wk": "63001fcd61119a7b", "layers.wv": "b7fc3f7e7736f5c5",
    "layers.wo": "73c8bd075a2048ce", "layers.w_gate": "7e908b2da2bb7c3c",
    "layers.w_up": "bb36c71195d6ef30", "layers.w_down": "f6292d513979cb42",
    "layers.ln_attn": "9381e0c19192483e",
    "layers.ln_mlp": "9381e0c19192483e",
}


def _dims(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_work_counts_are_the_parents(name):
    d = _dims(name)
    q = d["quest"]
    want = COUNTS[name]
    assert work.decode_step(d, q, DECODE, DOCS) == want["decode_step"]
    assert work.prefill_tick(d, q, PREFILL, DOCS) == want["prefill_tick"]
    assert work.decode_attention(d, q, DECODE, DOCS) == want[
        "decode_attention"]
    assert work.prefill_attention(d, q, PREFILL, DOCS) == want[
        "prefill_attention"]


def test_mistral_weights_are_the_parents_bit_for_bit():
    w = manifest.family("mistral").weights(TINY_CONFIG, 3, "cpu")
    leaves = {"embed": w["embed"], "final_norm": w["final_norm"],
              "lm_head": w["lm_head"],
              **{f"layers.{k}": v for k, v in w["layers"].items()}}
    got = {k: hashlib.sha256(v.contiguous().view(torch.int16).numpy()
                             .tobytes()).hexdigest()[:16]
           for k, v in leaves.items()}
    assert got == TINY_WEIGHTS
    assert all(v.dtype == torch.bfloat16 for v in leaves.values())


@pytest.mark.parametrize("name,fields", [
    ("mistral-7b-v0.3", dict(vocab_size=32768, hidden_size=4096,
                             num_layers=32, max_position_embeddings=32768)),
    ("mistral-nemo-12b-2407", dict(vocab_size=131072, hidden_size=5120,
                                   num_layers=40,
                                   max_position_embeddings=1024000))])
def test_model_config_is_what_build_engine_set(name, fields):
    from quest_tpu_torch.config import ModelConfig, RopeConfig
    cfg = manifest.family("mistral").model_config(_dims(name))
    assert cfg == ModelConfig(
        intermediate_size=14336, num_heads=32, num_kv_heads=8, head_dim=128,
        rms_norm_eps=1e-5, rope=RopeConfig(theta=1e6),
        tie_word_embeddings=False, dtype=torch.bfloat16, **fields)


@pytest.mark.parametrize("low_precision", [False, True])
def test_mistral_reference_is_forward_logits(low_precision):
    from reference.quest_ref import Sequence_, Shape, forward_logits
    dims, quest = TINY_CONFIG, TINY_CONFIG["quest"]
    fam = manifest.family("mistral")
    w = fam.weights(dims, 7, "cpu", torch.float32)
    g = np.random.default_rng(7)
    prefix = torch.from_numpy(g.integers(1, 256, 40))

    def seqs():
        return [Sequence_(tail=torch.from_numpy(g.integers(1, 256, n)),
                          served=torch.from_numpy(g.integers(1, 256, m)))
                for n, m in ((5, 12), (9, 30))]
    a, b = seqs(), seqs()
    for s, t in zip(a, b):
        t.tail, t.served = s.tail, s.served
    got = fam.reference(w, dims, quest, prefix, a, low_precision)
    shape = Shape(hidden=64, layers=3, heads=4, kv_heads=2, head_dim=16,
                  eps=1e-5, rope_theta=10000.0, page=4, budget_tokens=16,
                  skip_layers=1)
    want = forward_logits(w, shape, prefix, b, low_precision=low_precision)
    assert len(got) == len(want) == 2
    for r, s in zip(got, want):
        assert r.keys() == s.keys()
        assert all(torch.equal(r[k], s[k]) for k in r)


def test_unknown_model_type_names_the_known_families():
    with pytest.raises(SystemExit, match=r"unknown model_type 'nonesuch'.*"
                                         r"known families: \['mistral'\]"):
        manifest.family("nonesuch")
    with pytest.raises(SystemExit, match="unknown model_type"):
        work.decode_step(dict(_dims("mistral-7b-v0.3"),
                              model_type="nonesuch"), {}, [], {})


@pytest.mark.parametrize("workload,correct", [("tiny-closed", True),
                                              ("tiny-theta-closed", False)])
def test_a_family_added_as_a_file_is_found_and_checked(
        run_module, tiny_bench, workload, correct):
    # The copy's family is a file only there; the harness is the same.
    assert not (HERE / "families" / "mistral_theta.py").exists()
    assert (tiny_bench / "families" / "mistral_theta.py").exists()
    res, cmp, info = run_module.run_cell(workload, SEED, 2.0, trace=False,
                                         device="cpu", here=tiny_bench,
                                         t0=0.0)
    assert res["correct"] is correct, (cmp, info)
    gap = cmp["logit_gap_mean"]
    assert (gap["value"] <= gap["limit"]) is correct
    assert res["failed"] == 0
    assert cmp["tokens_checked_at_least"]["value"] >= 20


def test_a_family_count_replaces_the_harness_count(tmp_path):
    """A family that defines one of the work functions has it used, also
    inside the harness's other counts; the others stay the harness's."""
    here = tmp_path / "benchmark"
    shutil.copytree(HERE / "families", here / "families",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (here / "families" / "flat_prefill.py").write_text(
        "from pathlib import Path\n"
        "from bench import manifest\n"
        "_m = manifest.family('mistral', Path(__file__).resolve().parents[1])"
        "\n"
        "linear_params = _m.linear_params\n"
        "def prefill_attention(dims, quest, rows, doc_len):\n"
        "    return 1.0, 2.0\n")
    d = _dims("mistral-7b-v0.3")
    q, flat = d["quest"], dict(d, model_type="flat_prefill")
    lin, head = work.linear_params(d)
    assert work.prefill_attention(flat, q, PREFILL, DOCS, here) == (
        1.0, 2.0)
    real = sum(r[1] for r in PREFILL)
    assert work.prefill_tick(flat, q, PREFILL, DOCS, here) == (
        2.0 * lin * real + 2.0 * head * 4 + 1.0)
    assert work.decode_step(flat, q, DECODE, DOCS, here) == COUNTS[
        "mistral-7b-v0.3"]["decode_step"]


def test_harness_names_no_architecture():
    """The Llama layout, its port config and its model module are named
    only by the family and its reference."""
    files = [HERE / "run.py", HERE / "trace_report.py",
             *sorted((HERE / "bench").glob("*.py"))]
    for path in files:
        text = path.read_text()
        for word in ("w_gate", "intermediate_size", "RopeConfig(",
                     "models.llama"):
            assert word not in text, (path.name, word)
