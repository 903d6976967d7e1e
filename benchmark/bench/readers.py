"""Arithmetic the metric readers share (``benchmark/metrics/*.py``).
Each returns None where the run gave it nothing to read."""

from __future__ import annotations

import math
from typing import List, Optional

from bench import manifest, work


def percentile(values: List[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (0 < q <= 100)."""
    if not values:
        return None
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def ttft_s(rec) -> List[float]:
    """Each request due in the window: its first token's tick end minus its
    due time; one never answered counts the time to the drain's end."""
    return [(st.first if st.first is not None else rec.t_stop) - st.due
            for st in rec.window_requests()]


def tpot_s(rec) -> List[float]:
    """Each request due in the window: (last token - first) / (tokens - 1);
    one never finished counts the time from its due time to the drain's
    end, more than any gap a finished one reads."""
    out = []
    for st in rec.window_requests():
        if not st.done:
            out.append(rec.t_stop - st.due)
        elif len(st.tokens) > 1:
            out.append((st.last - st.first) / (len(st.tokens) - 1))
    return out


def tokens_per_s(rec) -> Optional[float]:
    """Every token event of the window's ticks over the window's wall
    time (its close is the end of the tick running at its end)."""
    ticks = rec.window_ticks()
    span = rec.t_close - rec.t_open
    if not ticks or span <= 0:
        return None
    return sum(t.events for t in ticks) / span


def decode_ticks(rec, unprofiled=True):
    return [t for t in rec.window_ticks(False if unprofiled else None)
            if t.kind == "decode" and t.steps]


def prefill_ticks(rec, unprofiled=True):
    return [t for t in rec.window_ticks(False if unprofiled else None)
            if t.kind == "prefill"]


def decode_step_ms(rec) -> Optional[float]:
    ticks = decode_ticks(rec)
    steps = sum(t.steps for t in ticks)
    if not steps:
        return None
    return 1e3 * sum(t.t1 - t.t0 for t in ticks) / steps


def decode_mfu(rec) -> Optional[float]:
    """100 x (the least time the decode steps' work needs at the chip's
    peaks) / (their ticks' host time)."""
    ticks = decode_ticks(rec)
    if not ticks or not rec.peaks:
        return None
    pf, pb = rec.peaks["bf16_flops_per_s"], rec.peaks["hbm_bytes_per_s"]
    docs = work.doc_tokens_of(rec)
    need = 0.0
    for t in ticks:
        for rows in work.decode_steps_of(t):
            if rows:
                f, b = work.decode_step(rec.dims, rec.quest, rows, docs,
                                        rec.here)
                need += max(f / pf, b / pb)
    return 100.0 * need / sum(t.t1 - t.t0 for t in ticks)


def prefill_mfu(rec) -> Optional[float]:
    ticks = prefill_ticks(rec)
    if not ticks or not rec.peaks:
        return None
    docs = work.doc_tokens_of(rec)
    flops = sum(work.prefill_tick(rec.dims, rec.quest, t.prefill_rows, docs,
                                  rec.here) for t in ticks)
    return 100.0 * flops / (rec.peaks["bf16_flops_per_s"]
                            * sum(t.t1 - t.t0 for t in ticks))


def roofline(rec, group: str) -> Optional[float]:
    """100 x (the least time the group's work in the profiled ticks needs at
    the chip's peaks) / (the group's kernels' device time there)."""
    if rec.device is None or not rec.peaks:
        return None
    g = (manifest.group(group, rec.here) if rec.here is not None
         else manifest.group(group))
    t = sum(s for name, s in rec.device["ops"].items()
            if any(k in name for k in g.KERNELS))
    f = b = 0.0
    for tick in rec.ticks:
        if tick.profiled:
            df, db = g.work(rec, tick)
            f, b = f + df, b + db
    if t <= 0 or (f <= 0 and b <= 0):
        return None
    return 100.0 * max(f / rec.peaks["bf16_flops_per_s"],
                       b / rec.peaks["hbm_bytes_per_s"]) / t


def idle_share(rec) -> Optional[float]:
    d = rec.device
    if d is None or d["window_s"] <= 0 or d["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
