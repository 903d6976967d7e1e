"""Shared pieces of the benchmark's CPU tests: ``benchmark/`` on the path
(the harness imports ``bench`` and ``reference`` from there, and the
port from the checkout), and a copy of the benchmark with a tiny
configuration and tiny mixes, for whole runs on the CPU's plain path.
The copy also holds a family of its own, ``mistral_theta``, and a tiny
configuration of that family: added files the harness finds by the
configuration's ``model_type``."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIG = {
    "name": "tiny", "source": "test", "model_type": "mistral",
    "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 3, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256,
    "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
    "max_position_embeddings": 512, "sliding_window": None,
    "tie_word_embeddings": False, "torch_dtype": "float32",
    "quest": {"page_size": 4, "token_budget": 16, "max_seq_len": 256,
              "skip_layers": 1, "group_agg": "sum",
              "selection": "per_kv_head", "kv_dtype": "float32",
              "meta_dtype": "float32", "topk_method": "exact",
              "fused_decode": False, "block_pages": 4},
    "reduced": [], "assumed": {}, "deployment": "a CPU test",
}
# ``mistral`` with a reference at another rope theta: a family that
# exists only in the copy, whose check must fail.
THETA_FAMILY = '''"""mistral; its reference rotates at 4x the rope theta."""
from pathlib import Path

from bench import manifest

_m = manifest.family("mistral", Path(__file__).resolve().parents[1])
weights, model_config = _m.weights, _m.model_config
trace_ranges, linear_params = _m.trace_ranges, _m.linear_params


def reference(w, dims, quest, prefix, seqs, low_precision=False):
    return _m.reference(w, dict(dims, rope_theta=4 * dims["rope_theta"]),
                        quest, prefix, seqs, low_precision)
'''
TINY_THETA_CONFIG = dict(TINY_CONFIG, name="tiny-theta",
                         model_type="mistral_theta")
ENGINE = {"max_batch": 4, "burst": 4, "prefill_bucket": 8,
          "prefill_chunk": 32, "prefix_cache_entries": 64,
          "pool_blocks": 64}
CHECK = {"mean_gap_limit": 1e-3, "max_checked_tokens": 400, "head_tokens": 64,
         "min_checked_tokens": 20}
TINY_CLOSED = {"kind": "closed_docqa", "clients": 4, "rounds": 40,
               "doc_tokens": 80, "question_tokens": [4, 12],
               "question_dist": "uniform", "answer_tokens": [6, 20],
               "answer_dist": "uniform", "lengths_seed": 5,
               "engine": ENGINE, "check": CHECK, "drain_s": 30,
               "trace_ticks": 6}
TINY_OPEN = {"kind": "open_docqa", "rate_per_s": 6.0, "block": 4, "docs": 3,
             "doc_tokens": 80, "question_tokens": [4, 12],
             "question_dist": "uniform", "answer_tokens": [6, 20],
             "answer_dist": "log_uniform", "lengths_seed": 6,
             "engine": ENGINE, "check": CHECK, "drain_s": 30,
             "trace_ticks": 6}


def tiny_manifest(real: dict) -> dict:
    """The real manifest with two tiny cells on the tiny configuration,
    which report the real metrics."""
    man = json.loads(json.dumps(real))
    for name in ("tiny", "tiny-theta"):
        man["configs"].append({"name": name, "source": "test",
                               "file": f"benchmark/configs/{name}.json",
                               "reduced": [], "why": "CPU test"})
    real_cells = [w["name"] for w in man["workloads"]]
    man["workloads"] += [
        {"name": "tiny-closed", "config": "tiny", "traffic": "tiny-closed",
         "chips": 1, "why": "CPU test"},
        {"name": "tiny-open", "config": "tiny", "traffic": "tiny-open",
         "chips": 1, "why": "CPU test"},
        {"name": "tiny-theta-closed", "config": "tiny-theta",
         "traffic": "tiny-closed", "chips": 1, "why": "CPU test"}]
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            wl = m["workloads"]
            if real_cells[0] in wl:
                wl += ["tiny-closed", "tiny-theta-closed"]
            if real_cells[1] in wl:
                wl.append("tiny-open")
    return man


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    """A copy of ``benchmark/`` (with its manifest) plus the tiny
    configurations, the ``mistral_theta`` family and the tiny mixes,
    added as files; returns the copy's ``benchmark/`` folder."""
    root = tmp_path_factory.mktemp("bench_root")
    here = root / "benchmark"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    man = tiny_manifest(json.loads((ROOT / "BENCHMARK.json").read_text()))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    (here / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (here / "configs" / "tiny-theta.json").write_text(
        json.dumps(TINY_THETA_CONFIG))
    (here / "families" / "mistral_theta.py").write_text(THETA_FAMILY)
    (here / "traffic" / "tiny-closed.json").write_text(json.dumps(TINY_CLOSED))
    (here / "traffic" / "tiny-open.json").write_text(json.dumps(TINY_OPEN))
    return here


@pytest.fixture(scope="session")
def run_module():
    """benchmark/run.py as a module."""
    from bench.manifest import load_module
    return load_module(HERE / "run.py", "bench_run_")
