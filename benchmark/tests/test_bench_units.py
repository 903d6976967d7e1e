"""CPU tests of the benchmark's pieces: the generators, the metric
arithmetic, the work counts, the configuration files, the import check
and the discovery of new files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from bench import manifest, readers, work
from bench.mix import Req
from bench.serve import Record, ReqState, Tick

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CLOSED = "m7b-docqa32k-closed"
OPEN = "nemo12b-docqa32k-open"


def _mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def _requests(traffic):
    if traffic.clients is not None:
        return [(c, r) for c, lst in enumerate(traffic.clients) for r in lst]
    return traffic.arrivals


@pytest.mark.parametrize("traffic", ["docqa32k-closed8", "docqa32k-open"])
def test_generator_same_seed_same_requests(traffic):
    mix = _mix(traffic)
    gen = manifest.generator(mix["kind"])
    a = gen.make(mix, 32768, 2 ** 31 + 77, 40.0)
    b = gen.make(mix, 32768, 2 ** 31 + 77, 40.0)
    c = gen.make(mix, 32768, 2 ** 31 + 78, 40.0)
    assert all((x == y).all() for x, y in zip(a.docs, b.docs))
    ra, rb, rc = _requests(a), _requests(b), _requests(c)
    assert len(ra) == len(rb)
    for (ka, x), (kb, y) in zip(ra, rb):
        assert ka == kb and x.doc == y.doc and x.max_new == y.max_new
        assert (x.tail == y.tail).all()
    # Another seed: other ids, the same sizes in another order.
    assert not all((x == y).all() for x, y in zip(a.docs, c.docs))
    sizes = sorted((r.tail.size, r.max_new) for _, r in ra)
    assert sizes == sorted((r.tail.size, r.max_new) for _, r in rc)
    assert [(r.tail.size, r.max_new) for _, r in ra] != [
        (r.tail.size, r.max_new) for _, r in rc]
    for _, r in ra:
        lo, hi = mix["question_tokens"]
        assert lo <= r.tail.size <= hi
        lo, hi = mix["answer_tokens"]
        assert lo <= r.max_new <= hi
        assert r.tail.min() >= 1 and r.tail.max() < 32768


def test_open_arrivals_cover_the_window_at_the_rate():
    mix = _mix("docqa32k-open")
    t = manifest.generator("open_docqa").make(mix, 131072, 5, 40.0)
    due = [d for d, _ in t.arrivals]
    assert due == sorted(due)
    # The schedule is scaled so the window holds exactly rate x seconds.
    assert sum(d < 40.0 for d in due) == round(mix["rate_per_s"] * 40)
    assert max(due) > 40.0
    # The same arrival times for every seed, the requests in another order.
    u = manifest.generator("open_docqa").make(mix, 131072, 6, 40.0)
    assert [d for d, _ in u.arrivals] == due
    assert [r.max_new for _, r in u.arrivals] != [
        r.max_new for _, r in t.arrivals]


def _rec(ticks, reqs, t_close, t_stop=None, max_batch=8):
    rec = Record(cell={}, dims={}, quest={}, engine={"max_batch": max_batch},
                 seconds=t_close)
    rec.t_open, rec.t_close = 0.0, t_close
    rec.t_stop = t_close if t_stop is None else t_stop
    rec.ticks = ticks
    rec.requests = {st.uid: st for st in reqs}
    return rec


def _reader(name):
    return manifest.reader(name)


def test_rate_counts_every_tick_and_a_stall_lowers_it():
    ticks = [Tick("decode", 0.1 * i, 0.1 * (i + 1), events=16, steps=16)
             for i in range(10)]
    rate = _reader("output_tokens_per_s").read(_rec(ticks, [], 1.0))
    assert rate == pytest.approx(160.0)
    # A stall of 0.5 s inside the window: the same work over 1.5 s.
    stalled = ticks[:5] + [Tick("decode", 0.5, 1.0, events=0, steps=0)] + [
        Tick("decode", t.t0 + 0.5, t.t1 + 0.5, events=16, steps=16)
        for t in ticks[5:]]
    assert _reader("output_tokens_per_s").read(
        _rec(stalled, [], 1.5)) == pytest.approx(160 / 1.5)
    # A tick that ends past the window's close is not counted.
    assert _reader("output_tokens_per_s").read(
        _rec(ticks, [], 0.95)) == pytest.approx(144 / 0.95)


class _Event:
    def __init__(self, uid):
        self.uid, self.token, self.finished = uid, 1, False


class _Engine:
    """Ticks of the given host durations, each serving 16 tokens of
    request 0; enough of ContinuousBatchingEngine for the server."""

    def __init__(self, durations):
        import types
        self.durations = list(durations)
        self.slots, self.prefix_hit_tokens, self.last_tick = [None], 0, None
        self.model = types.SimpleNamespace(prefill_last=None)
        for n in ("_admit_slots", "_prefill_tick", "_decode_burst",
                  "_gather"):
            setattr(self, n, lambda *a: None)

    def submit(self, request):
        pass

    def has_work(self):
        return bool(self.durations)

    def step(self):
        import time
        time.sleep(self.durations.pop(0))
        self.last_tick = "decode"
        return [_Event(0) for _ in range(16)]


def _served_rate(durations, seconds):
    from bench.mix import Traffic
    from bench.serve import Server
    req = Req(None, np.ones(4, np.int64), 10 ** 6)
    rec = Record(cell={}, dims={}, quest={}, engine={}, seconds=seconds)
    Server(_Engine(durations), Traffic(docs=[], setup=[], warm=[],
                                       clients=[[req]], drain_s=5.0),
           rec).window(seconds)
    return _reader("output_tokens_per_s").read(rec), rec


def test_a_stall_at_the_window_end_lowers_the_rate():
    import quest_tpu_torch.engine.scheduler  # noqa: F401  (imported untimed)
    rate, rec = _served_rate([0.02] * 30, 0.25)
    ticks = rec.window_ticks()
    # The tick running at the window's end is the window's, in full.
    t_end = rec.t_open + 0.25
    assert rec.t_close == max(t_end, ticks[-1].t1)
    assert ticks[-1].t0 < t_end
    assert rate == pytest.approx(16 * len(ticks) / (rec.t_close - rec.t_open))
    # A stall that starts in the last tick and runs past the end.
    stalled, srec = _served_rate([0.02] * 5 + [0.6] + [0.02] * 5, 0.25)
    assert srec.t_close - srec.t_open >= 0.6
    assert stalled < 0.5 * rate


def _req(uid, due, first, last, n, done=True):
    st = ReqState(uid=uid, req=Req(0, np.ones(8, np.int64), n), due=due,
                  in_window=True, doc_tokens=100)
    st.first, st.last, st.done = first, last, done
    st.tokens = list(range(n if done else 1))
    return st


def _ttft_p90_ms(rec):
    return 1e3 * readers.percentile(readers.ttft_s(rec), 90)


def test_tails_count_from_the_due_time_and_a_stall_moves_them():
    # 20 requests, one every 0.1 s, each answered 0.05 s after it is due,
    # 10 tokens over 0.09 s.
    reqs = [_req(i, 0.1 * i, 0.1 * i + 0.05, 0.1 * i + 0.14, 10)
            for i in range(20)]
    rec = _rec([], reqs, 2.0)
    assert _ttft_p90_ms(rec) == pytest.approx(50.0)
    assert _reader("tpot_p90_ms").read(rec) == pytest.approx(10.0)
    # A 1 s stall at t=0.5: everything due before 1.5 s waits for it.
    stalled = [_req(i, 0.1 * i, max(0.1 * i + 0.05, 1.5 + 0.01 * i)
                    if 5 <= i < 15 else 0.1 * i + 0.05,
                    max(0.1 * i + 0.14, 1.59 + 0.01 * i)
                    if 5 <= i < 15 else 0.1 * i + 0.14, 10)
               for i in range(20)]
    rec = _rec([], stalled, 2.0)
    # p90 by nearest rank of 20 values is the 18th smallest.
    ttft = sorted((st.first - st.due) * 1e3 for st in stalled)
    assert _ttft_p90_ms(rec) == pytest.approx(ttft[17])
    assert _ttft_p90_ms(rec) > 500.0
    # A request never answered counts the time to the drain's end.
    reqs[3] = _req(3, 0.3, None, None, 10, done=False)
    rec = _rec([], reqs, 2.0, t_stop=9.3)
    assert max(readers.ttft_s(rec)) == pytest.approx(9.0)
    assert _ttft_p90_ms(rec) == pytest.approx(50.0)
    assert max(readers.tpot_s(rec)) == pytest.approx(9.0)


def test_scheduler_shares():
    ticks = [Tick("decode", 0.0, 0.1, events=6 * 16, steps=16,
                  decode_rows=[(100, 0, u, 99) for u in range(6)]),
             Tick("prefill", 0.1, 0.2, events=1, width=256,
                  prefill_rows=[(31744, 200, 0, 9), (31744, 56, 1, 10)],
                  admitted=[9, 10], hit_tokens=2 * 31744),
             Tick("decode", 0.2, 0.3, events=8 * 16, steps=16,
                  decode_rows=[(100, 0, u, 99) for u in range(8)])]
    reqs = [_req(9, 0.0, 0.2, 0.3, 2), _req(10, 0.0, 0.2, 0.3, 2)]
    for st, tail in zip(reqs, (200, 56)):
        st.req = Req(0, np.ones(tail, np.int64), 2)
        st.doc_tokens = 31744
    rec = _rec(ticks, reqs, 0.3)
    assert _reader("live_row_share.tput").read(rec) == pytest.approx(
        100 * 14 / 16)
    assert _reader("prefill_useful_share.tpot").read(rec) == pytest.approx(
        100 * 256 / (8 * 256))
    assert _reader("prefix_hit_share.tpot").read(rec) == pytest.approx(
        100 * 2 * 31744 / (2 * 31744 + 256))
    assert _reader("decode_step_ms.tput").read(rec) == pytest.approx(
        1e3 * 0.2 / 32)


def _dims(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


# The values of each configuration as its source publishes them.
PUBLISHED = {
    "mistral-7b-v0.3": dict(
        hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, head_dim=128,
        vocab_size=32768, rope_theta=1e6, rms_norm_eps=1e-5,
        max_position_embeddings=32768, sliding_window=None,
        tie_word_embeddings=False),
    "mistral-nemo-12b-2407": dict(
        hidden_size=5120, intermediate_size=14336, num_hidden_layers=40,
        num_attention_heads=32, num_key_value_heads=8, head_dim=128,
        vocab_size=131072, rope_theta=1e6, rms_norm_eps=1e-5,
        sliding_window=None, tie_word_embeddings=False),
}
QUEST = dict(page_size=16, token_budget=2048, max_seq_len=32768,
             skip_layers=2, group_agg="sum", selection="per_kv_head",
             kv_dtype="bfloat16", meta_dtype="bfloat16", topk_method="exact",
             fused_decode=False, block_pages=64)


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_configuration_files(name):
    d = _dims(name)
    for k, v in PUBLISHED[name].items():
        assert d[k] == v, k
    assert d["quest"] == QUEST
    assert d["reduced"] == []
    man = manifest.manifest()
    entry = {c["name"]: c for c in man["configs"]}[name]
    assert entry["file"] == f"benchmark/configs/{name}.json"
    assert entry["source"] == d["source"]


def test_port_preset_is_the_mistral_file():
    from quest_tpu_torch.config import mistral_7b_v03
    cfg, d = mistral_7b_v03(), _dims("mistral-7b-v0.3")
    assert (cfg.vocab_size, cfg.hidden_size, cfg.intermediate_size,
            cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.max_position_embeddings, cfg.rope.theta) == (
        d["vocab_size"], d["hidden_size"], d["intermediate_size"],
        d["num_hidden_layers"], d["num_attention_heads"],
        d["num_key_value_heads"], d["head_dim"],
        d["max_position_embeddings"], d["rope_theta"])


def test_parameter_counts():
    # Mistral-7B: a layer 4096*4096 (q) + 2*4096*1024 (k, v) + 4096*4096
    # (o) + 3*4096*14336 (MLP) = 218,103,808; 32 layers; head 4096*32768.
    assert work.linear_params(_dims("mistral-7b-v0.3")) == (
        6_979_321_856, 134_217_728)
    # Nemo: 5120*4096 + 2*5120*1024 + 4096*5120 + 3*5120*14336 =
    # 272,629,760 a layer; 40 layers; head 5120*131072.
    assert work.linear_params(_dims("mistral-nemo-12b-2407")) == (
        10_905_190_400, 671_088_640)


@pytest.mark.parametrize("name,layers", [("mistral-7b-v0.3", 32),
                                         ("mistral-nemo-12b-2407", 40)])
def test_decode_attention_counts(name, layers):
    # Two rows on one 31744-token document, each with 200 tokens of its
    # own (n = 31944 after the append). Per row: 1997 pages, 13 of them
    # its own; 127 selected pages + the current page's 8 tokens = 2040
    # tokens. K+V of a token, one layer: 8*128*2*2 = 4096 bytes; a page's
    # min+max: 4096 bytes; q + output: 32*128*(2+4) = 24576 bytes a layer.
    d = _dims(name)
    rows = [(31944, 0, 1), (31944, 0, 2)]
    f, b = work.decode_attention(d, d["quest"], rows, {0: 31744})
    sparse = layers - 2
    row_bytes = (2 * 200 * 4096 + sparse * (13 * 4096 + 2040 * 4096)
                 + layers * 24576)
    doc_bytes = 2 * 31744 * 4096 + sparse * 1984 * 4096
    assert b == 2 * row_bytes + doc_bytes
    # FLOPs a row: dense layers 4*32*128*31944; sparse layers the
    # estimate 4*32*128*1997 and the attention 4*32*128*2040.
    assert f == 2 * (2 * 16384 * 31944 + sparse * 16384 * (1997 + 2040))
    if name == "mistral-7b-v0.3":
        assert b == 1_013_235_712
        assert f == 6_062_014_464


def test_prefill_attention_counts():
    # One row: 256 new tokens after a 31744-token borrowed prefix; keys
    # summed over queries 256*31744 + 256*257/2 = 8,159,360; 4*32*128
    # FLOPs a key a layer; bytes: the document's K+V once, the row's own
    # 256 tokens, its q (bf16) and output (f32).
    d = _dims("mistral-7b-v0.3")
    f, b = work.prefill_attention(d, d["quest"], [(31744, 256, 0, 1)],
                                  {0: 31744})
    assert f == 32 * 16384 * 8_159_360
    assert b == 32 * (31744 * 4096 + 256 * 4096 + 256 * 32 * 128 * 6)


def test_decode_step_counts_weights_once():
    d = _dims("mistral-7b-v0.3")
    rows = [(31944, 0, 1), (31944, 0, 2)]
    f, b = work.decode_step(d, d["quest"], rows, {0: 31744})
    fa, ba = work.decode_attention(d, d["quest"], rows, {0: 31744})
    lin, head = 6_979_321_856, 134_217_728
    assert f == 2 * (lin + head) * 2 + fa
    extra = 2 * (4096 * 2 + 32768 * 4 + 32 * 1024 * 2 * 4)
    assert b == (lin + head) * 2 + 65 * 4096 * 2 + ba + extra


def test_burst_rows_drop_the_junk_tail():
    t = Tick("decode", 0, 1, steps=4, decode_rows=[(10, 0, 1, 2),
                                                   (20, 0, 2, 9)])
    assert work.decode_steps_of(t) == [
        [(11, 0, 1), (21, 0, 2)], [(12, 0, 1), (22, 0, 2)],
        [(23, 0, 2)], [(24, 0, 2)]]


def test_import_check_compares_whole_top_level_names(run_module):
    f = run_module.forbidden_modules
    assert f(["quest_tpu_torch", "quest_tpu_torch.x", "jaxtyping",
              "numpy"]) == []
    assert f(["quest_tpu.x"]) == ["quest_tpu.x"]
    assert f(["jax.numpy", "quest_tpu_torch.ops"]) == ["jax.numpy"]
    assert f(["jaxlib", "flax.linen"]) == ["flax.linen", "jaxlib"]


def test_reference_imports_nothing_of_the_program():
    import ast
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in (
                    "quest_tpu_torch", "quest_tpu", "jax", "bench"), (path, n)


def test_manifest_metrics_each_have_a_reader_and_a_layer():
    man = manifest.manifest()
    cells = {w["name"] for w in man["workloads"]}
    for m in man["end_to_end"] + man["per_layer"]:
        assert hasattr(manifest.reader(m["name"]), "read")
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
    for w in cells:
        assert manifest.metrics_of(man, w, per_layer=True)
        assert "setup_s" in {m["name"] for m in
                             manifest.metrics_of(man, w, per_layer=False)}


def test_new_files_are_found_without_an_edit(tmp_path):
    """A new mix (with its own generator kind) and a new metric are files
    and manifest entries; nothing that is there changes."""
    here = tmp_path / "benchmark"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p.relative_to(here): p.read_bytes()
              for p in here.rglob("*") if p.is_file()}
    man = manifest.manifest()
    (here / "traffic" / "dummy_kind.py").write_text(
        "from bench.mix import Req, Traffic\n"
        "import numpy as np\n"
        "def make(p, vocab, seed, seconds):\n"
        "    return Traffic(docs=[], setup=[], warm=[], clients=[[Req(None,"
        " np.arange(1, p['n'] + 1), 3)]], engine={}, check={})\n")
    (here / "traffic" / "dummy.json").write_text(
        json.dumps({"kind": "dummy_kind", "n": 5}))
    (here / "metrics" / "dummy_count.py").write_text(
        "def read(rec):\n    return 42.0\n")
    man["workloads"].append({"name": "dummy-cell", "config": man["configs"][
        0]["name"], "traffic": "dummy", "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "dummy_count", "unit": "1",
                             "better": "higher", "source": "program_counter",
                             "layer": "device", "moves": "setup_s",
                             "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    c = manifest.cell(manifest.manifest(here), "dummy-cell", here)
    t = manifest.generator(c["traffic"]["kind"], here).make(
        c["traffic"], 32768, 1, 10.0)
    assert t.clients[0][0].tail.tolist() == [1, 2, 3, 4, 5]
    names = [m["name"] for m in manifest.metrics_of(
        manifest.manifest(here), "dummy-cell", per_layer=True)]
    assert names == ["dummy_count"]
    assert manifest.reader("dummy_count", here).read(None) == 42.0
    after = {p.relative_to(here): p.read_bytes()
             for p in here.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
