"""The program's own trace (``quest_tpu_torch/utils/trace.py``, its one
process-wide recorder) as the metric readers see it: the recorder's
``tick`` spans that ended inside the window, each flagged counted unless
it lies inside a tick of the harness's profiled sub-window, with the
device times its marks read (``work_ms``, ``step_ms``, ``gap_ms``).

Both clocks of a span are ``time.perf_counter``'s, in nanoseconds on the
program's side. A program without the recorder, a run without device
marks (the CPU) or a ring that dropped entries inside the window gives
None: the metric is then left out of the line.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

NS = 1e9


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from quest_tpu_torch.utils.trace import RECORDER
    except ImportError:
        return None
    return RECORDER


def window_ticks(rec, rcd=None) -> Optional[List[Tuple[object, bool]]]:
    """(tick span, counted) for every recorder tick that ended inside the
    window, in order; None as the module's docstring says."""
    rcd = recorder() if rcd is None else rcd
    if rcd is None:
        return None
    t_open, t_close = rec.t_open * NS, rec.t_close * NS
    if rcd.dropped and rcd.dropped_until >= t_open:
        return None
    profiled = [(t.t0 * NS, t.t1 * NS) for t in rec.ticks if t.profiled]
    out = [(s, not any(a <= s.t0 and s.t1 <= b for a, b in profiled))
           for s in rcd.spans("tick") if t_open <= s.t1 <= t_close]
    if not any("work_ms" in s.attrs for s, _ in out):
        return None
    return out


def counted_gaps(ticks) -> List[Tuple[object, object]]:
    """(tick n, tick n + 1) for each pair of consecutive counted ticks with
    marks whose first left work to do: the gaps the device waits for the
    host, not for arrivals."""
    return [(p, c) for (p, pc), (c, cc) in zip(ticks, ticks[1:])
            if pc and cc and "work_ms" in p.attrs and "gap_ms" in c.attrs
            and p.attrs.get("work_left")]


def tick_gap_share(rec, rcd=None) -> Optional[float]:
    """100 x the device-clock gaps between consecutive counted ticks over
    those gaps plus every counted tick's work (first mark to last)."""
    ticks = window_ticks(rec, rcd)
    if ticks is None:
        return None
    gaps = sum(c.attrs["gap_ms"] for _, c in counted_gaps(ticks))
    work = sum(s.attrs.get("work_ms", 0.0) for s, counted in ticks
               if counted)
    if gaps + work <= 0:
        return None
    return 100.0 * gaps / (gaps + work)


def decode_step_device_ms(rec, rcd=None) -> Optional[float]:
    """Device ms a decode step (one step mark to the next) over the counted
    decode ticks."""
    ticks = window_ticks(rec, rcd)
    if ticks is None:
        return None
    steps = [ms for s, counted in ticks if counted
             and s.attrs.get("kind") == "decode"
             for ms in s.attrs.get("step_ms", ())]
    return sum(steps) / len(steps) if steps else None


def prefill_tick_device_ms(rec, rcd=None) -> Optional[float]:
    """Device ms a prefill tick (its first mark to its last) over the
    counted prefill ticks."""
    ticks = window_ticks(rec, rcd)
    if ticks is None:
        return None
    work = [s.attrs["work_ms"] for s, counted in ticks if counted
            and s.attrs.get("kind") == "prefill" and "work_ms" in s.attrs]
    return sum(work) / len(work) if work else None
