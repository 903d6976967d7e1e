"""CPU tests of the ``mellum`` family (``families/mellum.py``): its work
counts at 1, 4 and 8 rows against literals worked out by hand; a whole
run of a tiny ``mellum`` configuration on the CPU's plain path reads
``correct``, and the same run with Quest's selection broken on the full
layers (``bench/faults.py``'s ``select_first``) does not; the control
(the reference in fp8) reads far above the program; the experts' kernel
group (``roofline/moe.py``) counts the program's experts read."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from bench import manifest, work
from bench.faults import planted
from conftest import CHECK, ENGINE, TINY_CLOSED, tiny_manifest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
SEED = 2 ** 31 + 12345
DOC = 130048


def _dims():
    return json.loads((HERE / "configs" / "mellum2-12b-a2.5b.json")
                      .read_text())


# One row at n = 130248 over the 130048-token document (its own 200):
# 7 full layers under Quest, 21 window layers, no dense full layer.
# Attention: 8141 pages, 2040 selected tokens (127 pages + 8); a window
# of 1024 keys, 824 of them the document's. K+V of a token and a page's
# min+max: 4 x 128 x 2 x 2 = 2048 bytes.
#   bytes = 7 (13 + 2040) 2048 + 21 x 200 x 2048 + 28 x 4096 x 6
#         + 7 x 8128 x 2048 + 21 x 824 x 2048 = 190,683,136
#   FLOPs = 4 x 4096 x (7 (8141 + 2040) + 21 x 1024) = 1,519,960,064
# Step: attention linears 2 x 2304 x 4096 + 2 x 2304 x 512 = 21,233,664,
# router 2304 x 64, an expert 3 x 2304 x 896 = 6,193,152, head 2304 x
# 98304; the experts read a layer at r rows: 64 (1 - (7/8)^r) = 8,
# 26.484375, 42.00903.
#   FLOPs = 2 (28 (21,233,664 + 147,456 + 8 x 6,193,152) + 226,492,416)
#         + attention = 5,944,819,712
#   bytes = 2 (28 (21,233,664 + 147,456 + 8 x 6,193,152) + 226,492,416)
#         + 57 x 2304 x 2 + attention + 2304 x 2 + 98304 x 4
#         + 28 x 4 x 128 x 2 x 4 = 4,616,317,952
COUNTS = {
    1: dict(experts=8.0, decode_step=(5944819712.0, 4616317952.0),
            decode_attention=(1519960064.0, 190683136.0)),
    4: dict(experts=26.484375, decode_step=(23779966976.0, 11145050624.0),
            decode_attention=(6080528384.0, 307191808.0)),
    8: dict(experts=42.009029388427734,
            decode_step=(47561768960.0, 16687454869.0),
            decode_attention=(12162891776.0, 463339520.0)),
}
PREFILL = [(DOC, 256, 0, 1), (0, 4096, None, 2), (512, 700, None, 3)]


@pytest.mark.parametrize("rows", sorted(COUNTS))
def test_work_counts_at_rows(rows):
    d = _dims()
    q = d["quest"]
    decode = [(DOC + 200 + i, 0, i) for i in range(rows)]
    want = COUNTS[rows]
    fam = manifest.family("mellum")
    assert fam.expected_experts(d, rows) == pytest.approx(want["experts"],
                                                          rel=1e-12)
    assert work.decode_step(d, q, decode, {0: DOC}) == want["decode_step"]
    assert work.decode_attention(d, q, decode, {0: DOC}) == want[
        "decode_attention"]


def test_prefill_counts():
    d = _dims()
    q = d["quest"]
    assert work.linear_params(d) == (1985937408, 226492416)
    assert work.prefill_attention(d, q, PREFILL, {0: DOC}) == (
        6408255995904.0, 5703849984.0)
    assert work.prefill_tick(d, q, PREFILL, {0: DOC}) == 26475526520832.0


TINY_MELLUM = {
    "name": "tiny-mellum", "source": "test", "model_type": "mellum",
    "hidden_act": "silu", "hidden_size": 64, "intermediate_size": 128,
    "layer_types": (["sliding_attention"] * 3 + ["full_attention"]) * 2,
    "num_hidden_layers": 8, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 256,
    "rms_norm_eps": 1e-6, "max_position_embeddings": 512,
    "sliding_window": 12, "num_experts": 8, "num_experts_per_tok": 2,
    "moe_intermediate_size": 32, "norm_topk_prob": True,
    "rope_parameters": {
        "full_attention": {"rope_type": "yarn", "rope_theta": 500000,
                           "factor": 4, "original_max_position_embeddings": 64,
                           "beta_fast": 32, "beta_slow": 1},
        "sliding_attention": {"rope_type": "default", "rope_theta": 500000}},
    "tie_word_embeddings": False, "torch_dtype": "float32",
    "quest": {"page_size": 4, "token_budget": 16, "max_seq_len": 256,
              "skip_layers": 2, "group_agg": "sum",
              "selection": "per_kv_head", "kv_dtype": "float32",
              "meta_dtype": "float32", "topk_method": "exact",
              "fused_decode": False, "block_pages": 4},
    "reduced": [], "assumed": {}, "deployment": "a CPU test",
}


@pytest.fixture(scope="module")
def mellum_bench(tmp_path_factory) -> Path:
    """A copy of ``benchmark/`` with the tiny ``mellum`` configuration and
    a cell of it under the tiny closed mix."""
    root = tmp_path_factory.mktemp("mellum_root")
    here = root / "benchmark"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    man = tiny_manifest(json.loads((ROOT / "BENCHMARK.json").read_text()))
    man["configs"].append({"name": "tiny-mellum", "source": "test",
                           "file": "benchmark/configs/tiny-mellum.json",
                           "reduced": [], "why": "CPU test"})
    man["workloads"].append({"name": "tiny-mellum-closed",
                             "config": "tiny-mellum",
                             "traffic": "tiny-closed", "chips": 1,
                             "why": "CPU test"})
    for m in man["end_to_end"]:
        if m["name"] == "output_tokens_per_s":
            m["workloads"].append("tiny-mellum-closed")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    (here / "configs" / "tiny-mellum.json").write_text(
        json.dumps(TINY_MELLUM))
    (here / "traffic" / "tiny-closed.json").write_text(json.dumps(
        dict(TINY_CLOSED, engine=ENGINE, check=CHECK)))
    return here


def _run(run_module, here, **kw):
    return run_module.run_cell("tiny-mellum-closed", SEED, 2.0, trace=False,
                               device="cpu", here=here, t0=0.0, **kw)


def test_tiny_mellum_run_is_correct_and_control_is_not(run_module,
                                                        mellum_bench):
    res, cmp, info = _run(run_module, mellum_bench, control=True)
    assert res["correct"], (cmp, info)
    assert res["failed"] == 0 and res["attempted"] > 0
    assert cmp["tokens_checked_at_least"]["value"] >= 20
    gap = cmp["logit_gap_mean"]["value"]
    assert info["control_mean_gap"] > max(3 * gap,
                                          cmp["logit_gap_mean"]["limit"])
    assert {"setup_s", "output_tokens_per_s"} <= set(res["metrics"])


def test_tiny_mellum_with_quest_broken_is_not_correct(run_module,
                                                      mellum_bench):
    with planted("select_first"):
        res, cmp, info = _run(run_module, mellum_bench)
    assert not res["correct"], (cmp, info)
    assert cmp["logit_gap_mean"]["value"] > cmp["logit_gap_mean"]["limit"]


def test_moe_group_work_reads_the_programs_count(monkeypatch):
    """``roofline/moe.py``: a profiled decode tick of 2 steps at 3 rows
    counts the experts the program read (its recorder tick inside the
    harness's tick), or the family's expectation without one."""
    from bench import program_trace
    from bench.serve import Record, Tick
    from quest_tpu_torch.utils.trace import Recorder

    class Clock:
        t = 0

        def __call__(self):
            return self.t

    clock = Clock()
    rcd = Recorder(capacity=16, clock=clock)
    clock.t = 1_100_000_000
    with rcd.span("tick", 1) as s:
        s.attrs.update(kind="decode", experts_read=1000)
        clock.t = 1_900_000_000
    d = _dims()
    rec = Record(cell={}, dims=d, quest=d["quest"], engine={}, seconds=1.0,
                 here=HERE)
    tick = Tick("decode", 1.0, 2.0, steps=2, profiled=True,
                decode_rows=[(DOC + 10, 0, 1, 50), (DOC + 20, 0, 2, 50),
                             (DOC + 30, 0, 3, 1)])
    group = manifest.group("moe")
    # An expert: 3 x 2304 x 896 = 6,193,152 bf16 parameters; a pair moves
    # its row, its SiLU product twice and its output (2304 + 1792 + 2304)
    # x 2 bytes; a step's router 2304 x 64 x 2 bytes and 3 rows' inputs.
    pairs = 2 * 28 * 3 * 8
    flops = 2.0 * 6193152 * pairs + 2.0 * 2 * 28 * 3 * 2304 * 64
    rest = pairs * 6400 * 2 + 2 * 28 * (2304 * 64 * 2 + 3 * 2304 * 2)
    monkeypatch.setattr(program_trace, "recorder", lambda: rcd)
    assert group.work(rec, tick) == (flops, 1000 * 6193152 * 2 + rest)
    monkeypatch.setattr(program_trace, "recorder", lambda: None)
    want = 2 * 28 * 64 * (1 - (7 / 8) ** 3)
    f, b = group.work(rec, tick)
    assert f == flops
    assert b == pytest.approx(want * 6193152 * 2 + rest, rel=1e-12)
    assert group.work(rec, Tick("prefill", 1.0, 2.0)) == (0.0, 0.0)
