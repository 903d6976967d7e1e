"""``metrics/prefill_computed_share.py`` on a hand-made recorder: real
prompt tokens over the tokens the counted prefill ticks of the window
computed; decode ticks, ticks before the window and ticks inside the
profiled sub-window are left out, and a ring that dropped entries inside
the window or a window without a prefill tick gives None."""

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
    clock.t = t0 * MS
    with rcd.span("tick", 1) as s:
        s.attrs.update(attrs)
        clock.t = t1 * MS


def _rec(profiled=()):
    rec = Record(cell={}, dims={}, quest={}, engine={"max_batch": 8},
                 seconds=0.9)
    rec.t_open, rec.t_close = 0.095, 1.0
    rec.ticks = [Tick("prefill", a / 1e3, b / 1e3, profiled=True)
                 for a, b in profiled]
    return rec


def _recorder(capacity=64):
    clock = Clock()
    rcd = Recorder(capacity=capacity, clock=clock)
    # Before the window: not read.
    _tick(rcd, clock, 0, 90, kind="prefill", work_ms=80.0, rows=8,
          prompt_tokens=2000, padded_tokens=2048, work_left=True)
    # In the window (95-1000 ms):
    _tick(rcd, clock, 100, 199, kind="prefill", work_ms=30.0, rows=2,
          prompt_tokens=300, padded_tokens=512, work_left=True)
    _tick(rcd, clock, 200, 299, kind="decode", work_ms=90.0, rows=8,
          steps=4, step_ms=[22.0] * 4, gap_ms=2.0, work_left=True,
          prompt_tokens=0, padded_tokens=1024)
    _tick(rcd, clock, 300, 399, kind="prefill", work_ms=20.0, rows=1,
          prompt_tokens=100, padded_tokens=128, gap_ms=2.0, work_left=True)
    _tick(rcd, clock, 400, 499, kind="prefill", work_ms=20.0, rows=1,
          prompt_tokens=60, padded_tokens=256, gap_ms=2.0, work_left=True)
    return rcd, clock


@pytest.fixture
def share(monkeypatch):
    """The metric's reader over a given recorder."""
    def read(rcd, rec):
        monkeypatch.setattr(program_trace, "recorder", lambda: rcd)
        return manifest.reader("prefill_computed_share.tput").read(rec)
    return read


def test_counted_prefill_ticks_of_the_window(share):
    rcd, _ = _recorder()
    assert share(rcd, _rec()) == pytest.approx(
        100 * (300 + 100 + 60) / (512 + 128 + 256))
    # The harness's profiled sub-window holds the third prefill tick.
    assert share(rcd, _rec(profiled=[(399.5, 499.5)])) == pytest.approx(
        100 * (300 + 100) / (512 + 128))


def test_no_prefill_tick_or_a_ring_drop_gives_none(share):
    rcd, clock = _recorder(capacity=5)
    profiled_all, _ = _recorder()
    assert share(rcd, _rec()) is not None
    assert share(profiled_all, _rec(profiled=[(99.5, 499.5)])) is None
    # A sixth tick in a ring of five drops the tick before the window:
    # still whole. A seventh drops one inside it.
    _tick(rcd, clock, 500, 599, kind="decode", work_ms=9.0, step_ms=[9.0],
          gap_ms=1.0, work_left=True)
    assert rcd.dropped == 1 and share(rcd, _rec()) is not None
    _tick(rcd, clock, 600, 699, kind="decode", work_ms=9.0, step_ms=[9.0],
          gap_ms=1.0, work_left=True)
    assert share(rcd, _rec()) is None


def test_no_marks_or_no_recorder_gives_none(share, monkeypatch):
    clock = Clock()
    rcd = Recorder(clock=clock)
    _tick(rcd, clock, 100, 200, kind="prefill", rows=1, prompt_tokens=10,
          padded_tokens=16, work_left=True)
    assert share(rcd, _rec()) is None
    monkeypatch.setattr(program_trace, "recorder", lambda: None)
    assert manifest.reader("prefill_computed_share.tpot").read(
        _rec()) is None


def test_the_metric_is_in_the_manifest():
    per_layer = {m["name"]: m for m in manifest.manifest()["per_layer"]}
    for suffix, moves, cell in (
            ("tput", "output_tokens_per_s", "m7b-docqa32k-closed"),
            ("tpot", "tpot_p90_ms", "nemo12b-docqa32k-open")):
        m = per_layer[f"prefill_computed_share.{suffix}"]
        assert m["moves"] == moves and m["workloads"] == [cell]
        assert m["source"] == "program_counter" and m["better"] == "higher"
        assert m["unit"] == "%"
