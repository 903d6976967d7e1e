"""The readers of the program's own trace (``bench/program_trace.py``) on
a hand-made recorder: the arithmetic of the gap share, the decode step's
and the prefill tick's device ms; gaps after a tick that left no work are
left out, ticks inside the profiled sub-window are left out, a ring that
dropped entries inside the window and a run without device marks give
None, and so does a program without the recorder."""

from __future__ import annotations

import pytest

from bench import manifest, program_trace
from bench.serve import Record, Tick
from quest_tpu_torch.utils.trace import Recorder

MS = 1_000_000           # ns


class Clock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


def _tick(rcd, clock, t0, t1, **attrs):
    """A recorder tick span from t0 to t1 (ms) with ``attrs``."""
    clock.t = t0 * MS
    with rcd.span("tick", 1) as s:
        s.attrs.update(attrs)
        clock.t = t1 * MS
    return s


def _rec(t_open_ms, t_close_ms, profiled=()):
    rec = Record(cell={}, dims={}, quest={}, engine={"max_batch": 8},
                 seconds=(t_close_ms - t_open_ms) / 1e3)
    rec.t_open, rec.t_close = t_open_ms / 1e3, t_close_ms / 1e3
    rec.ticks = [Tick("decode", a / 1e3, b / 1e3, profiled=True)
                 for a, b in profiled]
    return rec


def _recorder(capacity=64):
    clock = Clock()
    rcd = Recorder(capacity=capacity, clock=clock)
    # Before the window: a prefill tick whose gap must not be read.
    _tick(rcd, clock, 0, 90, kind="prefill", work_ms=80.0, work_left=True)
    # In the window (100-1000 ms):
    _tick(rcd, clock, 100, 199, kind="decode", work_ms=90.0,
          step_ms=[22.0, 22.0, 22.0, 22.0], gap_ms=5.0, work_left=True)
    _tick(rcd, clock, 200, 299, kind="prefill", work_ms=60.0, gap_ms=4.0,
          work_left=True)
    _tick(rcd, clock, 300, 399, kind="decode", work_ms=80.0,
          step_ms=[20.0, 20.0, 20.0, 20.0], gap_ms=6.0, work_left=False)
    # After an idle engine: its gap is the arrivals', not counted.
    _tick(rcd, clock, 600, 699, kind="prefill", work_ms=70.0, gap_ms=150.0,
          work_left=True)
    _tick(rcd, clock, 700, 799, kind="decode", work_ms=40.0,
          step_ms=[10.0, 10.0], gap_ms=2.0, work_left=True)
    return rcd, clock


def test_readers_on_a_hand_made_recorder():
    rcd, _ = _recorder()
    rec = _rec(95, 1000)
    # Counted gaps: 4, 6 and 2. The first window tick's own gap follows a
    # tick outside the window, and the fourth's follows work_left = False.
    work = 90 + 60 + 80 + 70 + 40
    assert program_trace.tick_gap_share(rec, rcd) == pytest.approx(
        100 * 12 / (12 + work))
    assert program_trace.decode_step_device_ms(rec, rcd) == pytest.approx(
        (88 + 80 + 20) / 10)
    assert program_trace.prefill_tick_device_ms(rec, rcd) == pytest.approx(
        (60 + 70) / 2)


def test_profiled_ticks_are_left_out():
    rcd, _ = _recorder()
    # The harness's profiled ticks hold the second and third window ticks.
    rec = _rec(95, 1000, profiled=[(199.5, 299.5), (299.5, 399.5)])
    assert program_trace.decode_step_device_ms(rec, rcd) == pytest.approx(
        (88 + 20) / 6)
    assert program_trace.prefill_tick_device_ms(rec, rcd) == 70
    # Only the last gap lies between two counted ticks.
    work = 90 + 70 + 40
    assert program_trace.tick_gap_share(rec, rcd) == pytest.approx(
        100 * 2 / (2 + work))


def test_a_ring_that_dropped_inside_the_window_gives_none():
    rcd, clock = _recorder(capacity=6)
    rec = _rec(95, 1000)
    # Six ticks in a ring of six: nothing dropped.
    assert rcd.dropped == 0
    assert program_trace.tick_gap_share(rec, rcd) is not None
    _tick(rcd, clock, 800, 900, kind="decode", work_ms=90.0,
          step_ms=[45.0, 45.0], gap_ms=1.0, work_left=True)
    # The tick before the window went: still whole.
    assert rcd.dropped == 1 and rcd.dropped_until == 90 * MS
    assert program_trace.decode_step_device_ms(rec, rcd) == pytest.approx(
        (88 + 80 + 20 + 90) / 12)
    _tick(rcd, clock, 900, 950, kind="decode", work_ms=9.0, step_ms=[9.0],
          gap_ms=1.0, work_left=True)
    for name in ("tick_gap_share", "decode_step_device_ms",
                 "prefill_tick_device_ms"):
        assert getattr(program_trace, name)(rec, rcd) is None


def test_no_marks_or_no_recorder_gives_none(monkeypatch):
    clock = Clock()
    rcd = Recorder(clock=clock)
    _tick(rcd, clock, 100, 200, kind="decode", rows=8, steps=4,
          work_left=True)
    rec = _rec(95, 1000)
    assert program_trace.window_ticks(rec, rcd) is None
    assert program_trace.tick_gap_share(rec, rcd) is None
    # A program without the recorder: the metric's reader gives None.
    monkeypatch.setattr(program_trace, "recorder", lambda: None)
    for name in ("tick_gap_share.tput", "decode_step_device_ms.tpot",
                 "prefill_tick_device_ms.tput"):
        assert manifest.reader(name).read(rec) is None


def test_the_readers_are_in_the_manifest():
    man = manifest.manifest()
    per_layer = {m["name"]: m for m in man["per_layer"]}
    for base in ("tick_gap_share", "decode_step_device_ms",
                 "prefill_tick_device_ms"):
        for suffix, moves, cell in (
                ("tput", "output_tokens_per_s", "m7b-docqa32k-closed"),
                ("tpot", "tpot_p90_ms", "nemo12b-docqa32k-open")):
            m = per_layer[f"{base}.{suffix}"]
            assert m["moves"] == moves and m["workloads"] == [cell]
            assert m["source"] == "device_trace" and m["better"] == "lower"
