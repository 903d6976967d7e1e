"""The port's trace recorder (``quest_tpu_torch/utils/trace.py``) inside
the continuous-batching scheduler and the step graphs, on a tiny CPU
engine: one ``tick`` span a ``step()`` with its children nested, tick
attributes equal to what the benchmark's harness reads by wrapping the
engine's methods, each request's events in order, the ring's capacity
and drop count, profiler ranges only under a profiler, the device marks'
arithmetic (with stand-in events) and the recorder's host cost a tick.
The card case (``cuda`` marker) reads real device marks: ``python -m
pytest --noconftest -m cuda tests/test_torch_trace.py``."""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from quest_tpu_torch.config import QuestConfig, tiny_test_model
from quest_tpu_torch.engine import ContinuousBatchingEngine, Request
from quest_tpu_torch.engine.graphs import StepGraphs
from quest_tpu_torch.models.llama import init_params
from quest_tpu_torch.utils import trace
from quest_tpu_torch.utils.trace import RECORDER, DeviceMarks, Recorder

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

KINDS = ("prefill_tick", "decode_burst")
CHILDREN = ("prepare", "enqueue", "fetch", "emit")


def _engine(device="cpu", **kw):
    cfg = dataclasses.replace(tiny_test_model(), num_layers=2)
    quest = QuestConfig(page_size=8, token_budget=32, max_seq_len=256,
                        skip_layers=1, block_pages=4,
                        kv_dtype=(torch.float32 if device == "cpu"
                                  else torch.bfloat16))
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    return ContinuousBatchingEngine(cfg, quest, params, max_batch=3,
                                    prefill_bucket=8, burst=4,
                                    prefill_chunk=24, device=device, **kw)


def _requests():
    """A shared 40-token document (a prefix hit after the first) under
    questions of several lengths, and one request with its own prompt."""
    rng = np.random.default_rng(3)
    doc = rng.integers(1, 256, size=40).tolist()
    reqs = [Request(uid=u, prompt=doc + rng.integers(1, 256, size=n).tolist(),
                    max_new_tokens=m)
            for u, (n, m) in enumerate([(5, 6), (9, 3), (3, 9), (12, 5)])]
    reqs.append(Request(uid=4, prompt=rng.integers(1, 256, size=30).tolist(),
                        max_new_tokens=7))
    return reqs


class Harness:
    """What ``benchmark/bench/serve.py:Instrument`` reads a tick, by the
    same wrappers around the same names: live decode rows and steps
    (``_tok_fn.calls``), real prompt tokens (``prefill_pos``), the rows
    and tokens a prefill computes (``model.prefill_last``'s tokens: rows
    x padded width) and the hit tokens gained (``prefix_hit_tokens``)."""

    def __init__(self, eng):
        self.eng, self.tick = eng, None
        burst, prefill = eng._decode_burst, eng._prefill_tick
        admit, last = eng._admit_slots, eng.model.prefill_last

        def decode_burst(decoding):
            calls = eng._tok_fn.calls + eng._sample_fn.calls
            out = burst(decoding)
            self.tick.update(rows=len(decoding), steps=eng._tok_fn.calls
                             + eng._sample_fn.calls - calls)
            return out

        def prefill_tick(pf):
            pos = [(eng.slots[b], eng.slots[b].prefill_pos) for b in pf]
            out = prefill(pf)
            self.tick["prompt_tokens"] = sum(s.prefill_pos - p
                                             for s, p in pos)
            return out

        def admit_slots():
            hits = eng.prefix_hit_tokens
            admit()
            self.tick["hit_tokens"] = eng.prefix_hit_tokens - hits

        def prefill_last(cache, toks, new_lens=None):
            self.tick.update(rows=int(toks.shape[0]),
                             padded_tokens=int(toks.shape[0] * toks.shape[1]))
            return last(cache, toks, new_lens)

        eng._decode_burst, eng._prefill_tick = decode_burst, prefill_tick
        eng._admit_slots, eng.model.prefill_last = admit_slots, prefill_last

    def run(self, reqs):
        ticks = []
        for r in reqs:
            self.eng.submit(r)
        while self.eng.has_work():
            self.tick = {}
            self.eng.step()
            ticks.append(dict(self.tick, kind=self.eng.last_tick))
        return ticks


@pytest.fixture(scope="module")
def served():
    """One run of the request set, wrapped as the harness wraps it: the
    harness's ticks, the recorder's entries and the engine."""
    RECORDER.clear()
    eng = _engine()
    ticks = Harness(eng).run(_requests())
    return ticks, RECORDER.entries(), eng


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_each_step_is_one_tick_span_with_its_children_nested(served):
    ticks, entries, eng = served
    spans = [e for e in entries if isinstance(e, trace.Span)]
    tick_spans = [s for s in spans if s.name == "tick"]
    assert len(tick_spans) == len(ticks)
    assert all(s.parent == 0 and s.engine == eng._trace_id
               for s in tick_spans)
    for t, h in zip(tick_spans, ticks):
        assert t.attrs["kind"] == h["kind"]
        kids = _children(spans, t)
        names = [k.name for k in kids]
        want = ["admit"] + ([] if h["kind"] is None else
                            [KINDS[h["kind"] == "decode"]])
        assert names == want
        for k in kids:
            assert t.t0 <= k.t0 <= k.t1 <= t.t1
        if h["kind"] is None:
            continue
        body = kids[1]
        parts = _children(spans, body)
        assert [p.name for p in parts] == list(CHILDREN)
        assert all(body.t0 <= p.t0 <= p.t1 <= body.t1 for p in parts)
        assert all(a.t1 <= b.t0 for a, b in zip(parts, parts[1:]))
        assert all(p.engine == eng._trace_id for p in parts)
        assert not any(_children(spans, p) for p in parts)
    assert {s.name for s in spans} == {"tick", "admit", *KINDS, *CHILDREN}


def test_tick_attributes_equal_what_the_harness_reads(served):
    ticks, entries, eng = served
    tick_spans = [e for e in entries if isinstance(e, trace.Span)
                  and e.name == "tick"]
    kinds = {h["kind"] for h in ticks}
    assert {"prefill", "decode"} <= kinds
    for t, h in zip(tick_spans, ticks):
        a = t.attrs
        for key in ("rows", "steps", "prompt_tokens", "padded_tokens",
                    "hit_tokens"):
            assert a.get(key) == h.get(key), (key, a, h)
        assert len(a["free_blocks"]) == 1 and a["queue"] >= 0
        # No marks on the CPU.
        assert not {"work_ms", "step_ms", "gap_ms"} & set(a)
    assert any(h["kind"] == "prefill" and h["rows"] < eng.max_batch
               for h in ticks)
    assert sum(h["hit_tokens"] for h in ticks) == eng.prefix_hit_tokens > 0
    assert [t.attrs["work_left"] for t in tick_spans] == [True] * (
        len(ticks) - 1) + [False]
    # The last tick reads the pool as the run leaves it.
    assert tick_spans[-1].attrs["free_blocks"] == [
        eng.pools[0].free_pages()]
    admits = [s for s in entries if isinstance(s, trace.Span)
              and s.name == "admit"]
    got = [pair for s in admits for pair in s.attrs["admitted"]]
    assert sorted(u for u, _ in got) == list(range(5))
    assert sum(h for _, h in got) == eng.prefix_hit_tokens


def test_each_request_submits_admits_answers_and_finishes_in_order(served):
    _, entries, eng = served
    events = [e for e in entries if isinstance(e, trace.Event)]
    by_uid = {}
    for e in events:
        assert e.engine == eng._trace_id
        by_uid.setdefault(e.uid, []).append(e)
    assert sorted(by_uid) == list(range(5))
    for uid, evs in by_uid.items():
        assert [e.name for e in evs] == ["submit", "admit", "first_token",
                                         "finish"], uid
        assert all(a.t <= b.t for a, b in zip(evs, evs[1:]))


def test_ring_keeps_its_capacity_and_counts_what_it_drops():
    now = [0]

    def clock():
        now[0] += 10
        return now[0]

    rec = Recorder(capacity=8, clock=clock)
    for i in range(5):
        with rec.span("tick", 1, i=i):
            rec.event("submit", i)
    assert len(rec.entries()) == 8 and rec.dropped == 2
    # The two oldest went: event 0 (at 20) and span 0 (closed at 30).
    assert rec.dropped_until == 30
    kept = rec.entries()
    assert [e.t1 if isinstance(e, trace.Span) else e.t for e in kept] == (
        sorted(e.t1 if isinstance(e, trace.Span) else e.t for e in kept))
    assert [s.attrs["i"] for s in rec.spans("tick")] == [1, 2, 3, 4]
    assert [e.uid for e in rec.events()] == [1, 2, 3, 4]
    rec.clear()
    assert rec.entries() == [] and rec.dropped == 0
    assert trace.CAPACITY >= 10_000     # two windows of the busiest cell


def test_spans_are_profiler_ranges_only_while_a_profiler_runs(monkeypatch):
    eng = _engine()
    reqs = _requests()[:2]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        RECORDER.clear()
        eng.run(reqs)
    names = [e.name for e in prof.events()
             if e.name.startswith(trace.PROFILER_PREFIX)]
    spans = RECORDER.spans()
    assert sorted(names) == sorted(trace.PROFILER_PREFIX + s.name
                                   for s in spans)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built unprofiled")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    RECORDER.clear()
    assert eng.run(_requests()[2:4])
    assert len(RECORDER.spans("tick")) > 0


def test_capture_is_a_span():
    class Graph:
        def __init__(self, graphs):
            pass

        def capture(self, body, generators):
            return body()

        def replay(self):
            pass

    RECORDER.clear()
    fn = StepGraphs("cpu", new_graph=Graph).compile(lambda x: x + 1)
    with RECORDER.span("enqueue", 7):
        for i in range(3):
            fn(torch.zeros(2))
        fn(torch.zeros(3))
    caps = RECORDER.spans("capture")
    assert len(caps) == 2 and all(c.engine == 7 for c in caps)
    assert caps[0].attrs["fn"] == "<lambda>"


class _Event:
    """A stand-in for ``torch.cuda.Event`` on a counting clock (ms)."""
    now = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        _Event.now += 1.5
        self.t = _Event.now

    def elapsed_time(self, other):
        return other.t - self.t


def test_device_marks_give_steps_work_and_the_gap(monkeypatch):
    attrs = {}
    DeviceMarks("cpu").read(attrs)
    assert attrs == {}
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    marks = DeviceMarks("cpu")
    marks.on = True
    for _ in range(5):                      # start, 3 steps, end
        marks.mark()
    first = {}
    marks.read(first)
    # The steps wait for the next tick's settle (or an idle engine's).
    assert first == {"work_ms": 6.0}
    _Event.now += 10.0                      # the device idles
    marks.mark()
    marks.mark()
    marks.settle()
    assert first == {"work_ms": 6.0, "step_ms": [1.5, 1.5, 1.5]}
    second = {}
    marks.read(second)
    marks.settle()
    assert second == {"work_ms": 1.5, "gap_ms": 11.5}
    # Seven events serve both ticks (the first tick's four wait for the
    # settle while the second records), and the pool hands them back.
    assert len(marks._pool) + 1 == 7
    marks.mark()
    marks.mark()
    assert len(marks._pool) + 1 == 5


def test_recorder_cost_per_tick_is_small():
    """The recorder's host work for a decode tick (7 spans with their
    attributes, 4 request events, the marks' read), median of 200: about
    15 us on one Xeon core, held under 300 us (ticks last tens of ms)."""
    rec = Recorder()
    marks = DeviceMarks("cpu")

    def tick():
        with rec.span("tick", 1) as t:
            with rec.span("admit") as a:
                a.attrs["admitted"] = []
            with rec.span("decode_burst"):
                for name in CHILDREN:
                    with rec.span(name):
                        pass
            for uid in range(4):
                rec.event("finish", uid)
            t.attrs.update(kind="decode", rows=8, steps=16, hit_tokens=0,
                           queue=0, free_blocks=[3], work_left=True)
            marks.read(t.attrs)

    times = []
    for _ in range(200):
        t0 = time.perf_counter()
        tick()
        times.append(time.perf_counter() - t0)
    assert np.median(times) < 300e-6, np.median(times)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_marks_on_card(cuda):
    """Every tick with a launch reads its device ms; a decode tick one
    step time a step; ticks after the first the gap since the last; and
    the device times fit inside the host's."""
    from quest_tpu_torch.config import small_tpu_model
    cfg = dataclasses.replace(small_tpu_model(), num_layers=2)
    quest = QuestConfig(page_size=16, token_budget=64, max_seq_len=512,
                        skip_layers=1)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    eng = ContinuousBatchingEngine(cfg, quest, params, max_batch=2,
                                   prefill_bucket=16, burst=4, device="cuda")
    rng = np.random.default_rng(0)
    RECORDER.clear()
    eng.run([Request(uid=u, prompt=rng.integers(1, 2048, size=n).tolist(),
                     max_new_tokens=m)
             for u, (n, m) in enumerate([(40, 9), (70, 5), (20, 12)])])
    ticks = [t for t in RECORDER.spans("tick") if t.attrs["kind"]]
    assert ticks and all(t.attrs["work_ms"] > 0 for t in ticks)
    assert "gap_ms" not in ticks[0].attrs
    for t in ticks[1:]:
        assert t.attrs["gap_ms"] > 0
    for t in ticks:
        a = t.attrs
        host_ms = (t.t1 - t.t0) / 1e6
        assert a["work_ms"] < host_ms
        if a["kind"] == "decode":
            assert len(a["step_ms"]) == a["steps"]
            assert sum(a["step_ms"]) <= a["work_ms"] + 1e-3
        else:
            assert "step_ms" not in a
    assert len(RECORDER.spans("capture")) >= 1
