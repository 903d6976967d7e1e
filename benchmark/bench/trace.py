"""The profiled sub-window of a ``--trace 1`` run and what its trace
says: device busy time (the union of every device op's interval), each
op's device seconds by name, and the device's idle time split by what
the host was doing meanwhile (the innermost harness span open, or
``between_ticks``).

The profiler is started once in set-up (``warm``), so its start-up cost
stays out of the window. In the window it runs from the first tick
boundary past ``START_FRAC`` of the window for ``ticks`` scheduler
ticks; it idles ``MARGIN_S`` inside both edges, because the profiler
drops device ops whose times fall outside its own window and the card's
clock can lag the host's by a millisecond or two. The sub-window read
is from the start of its first tick's span to the end of its last.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional

import torch

from bench.serve import SPAN_PREFIX

MARGIN_S = 0.05
START_FRAC = 0.4


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


class Tracer:
    def __init__(self, ticks: int):
        self.ticks = ticks
        self.prof = None
        self.state = "wait"
        self.count = 0

    @staticmethod
    def warm() -> None:
        """Start and stop a profiler once, in set-up."""
        with _profiler():
            torch.zeros(1).add_(1)
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    def before_tick(self, elapsed: float, seconds: float) -> None:
        if self.state == "wait" and elapsed >= START_FRAC * seconds:
            self.prof = _profiler()
            self.prof.__enter__()
            time.sleep(MARGIN_S)
            self.state = "on"

    def after_tick(self) -> bool:
        if self.state != "on":
            return False
        self.count += 1
        if self.count >= self.ticks:
            self._stop()
        return True

    def _stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        time.sleep(MARGIN_S)
        self.prof.__exit__(None, None, None)
        self.state = "done"

    def finish(self) -> None:
        if self.state == "on":
            self._stop()

    def summary(self, extra_skip=()) -> Optional[Dict]:
        """The sub-window's device record, or None without a trace."""
        if self.prof is None:
            return None
        return summarize(self.prof.events(), extra_skip)


def summarize(events, extra_skip=()) -> Optional[Dict]:
    """``window_s``, ``busy_s``, ``ops`` (name -> device seconds), ``op_list``
    (name, start, end in seconds) and ``gaps`` (host span -> [idle s,
    pieces, longest piece s]) of profiler ``events``; None when no tick
    span is there."""
    from torch.autograd import DeviceType
    skip = set(extra_skip)
    ops, spans = [], []
    for e in events:
        name = e.name
        t0, t1 = e.time_range.start / 1e6, e.time_range.end / 1e6
        if name.startswith(SPAN_PREFIX):
            if e.device_type == DeviceType.CPU:
                spans.append((name[len(SPAN_PREFIX):], t0, t1))
            continue
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and name not in skip):
            ops.append((name, t0, t1))
    ticks = [s for s in spans if s[0] == "tick"]
    if not ticks:
        return None
    w0, w1 = min(s[1] for s in ticks), max(s[2] for s in ticks)
    inside = sorted((n, max(a, w0), min(b, w1)) for n, a, b in ops
                    if b > w0 and a < w1)
    inside.sort(key=lambda o: o[1])
    busy, gaps_at, cur0, cur1 = 0.0, [], None, None
    last_end = w0
    for _, a, b in inside:
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            if a > last_end:
                gaps_at.append((last_end, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
        last_end = max(last_end, b)
    if cur1 is not None:
        busy += cur1 - cur0
    if w1 > last_end:
        gaps_at.append((last_end, w1))
    per_op: Dict[str, float] = {}
    for n, a, b in inside:
        per_op[n] = per_op.get(n, 0.0) + (b - a)
    # The host's timeline: the innermost harness span open in each piece.
    cuts = sorted({w0, w1} | {t for s in spans for t in s[1:]
                              if w0 < t < w1})
    pieces = []
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        open_ = [s for s in spans if s[1] <= mid <= s[2]]
        pieces.append((a, b, max(open_, key=lambda s: s[1])[0]
                       if open_ else "between_ticks"))
    starts = [p[0] for p in pieces]
    gaps: Dict[str, List[float]] = {}
    for a, b in gaps_at:
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(pieces) and pieces[i][0] < b:
            lo, hi = max(a, pieces[i][0]), min(b, pieces[i][1])
            if hi > lo:
                g = gaps.setdefault(pieces[i][2], [0.0, 0, 0.0])
                g[0] += hi - lo
                g[1] += 1
                g[2] = max(g[2], hi - lo)
            i += 1
    return dict(window_s=w1 - w0, busy_s=busy, ops=per_op, op_list=inside,
                gaps=gaps, ticks=len(ticks))
