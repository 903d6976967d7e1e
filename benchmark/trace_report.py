"""One traced run of a cell, as ``run.py --trace 1`` makes it, with a
report read from the program's own trace (``quest_tpu_torch/utils/
trace.py``) over the run's window:

    python3 benchmark/trace_report.py --workload <name> --seed <n> --seconds <s>

prints one ``trace_report`` JSON object, then the run's ``info`` and
result lines as ``run.py`` prints them. The report's keys:

- ``ticks``: the window's recorder ticks by kind, those counted (outside
  the profiled sub-window) and the three per-layer readers' values;
- ``clocks``: over each maximal run of consecutive counted ticks, the
  device clock's gaps plus work against the host's time from the run's
  first ``enqueue`` to its last ``fetch`` end (the largest relative
  difference, and the sums);
- ``gaps``: the counted gaps between ticks split on the host's clock:
  the previous tick's ``emit``, the harness between ticks, the next
  tick's ``admit`` and ``prepare``, the rest of both ticks, and what
  remains of the device gap (the fetch's copy and the host's wake-up),
  in mean ms a gap, with the longest gap and fetch tail and the mean
  fetch tail after each kind of tick;
- ``idle_by_span``: the profiled sub-window's device idle seconds by the
  innermost program span open on the host (``bench/trace.py``'s split
  over the program's spans in place of the harness's);
- ``tick_ranges``: each ``quest.tick`` profiler range against its
  recorded span (the largest difference in us, also at the measured rate
  of the profiler's clock);
- ``requests``: time to first token, p50 and p90, with its two parts:
  queue wait (``submit`` -> ``admit``) and ``admit`` -> ``first_token``;
- ``pool``, ``captures``, ``ring``: the least free blocks in the window,
  graph captures in the window, the ring's entries and drops;
- ``device_ops_quest``: program span names among the breakdown's device
  ops (none expected); ``gc``: the process's collections by generation;
- ``cost``: the recorder's host us for a decode tick of 16 steps (spans,
  events, 18 marks and their reads) on this device, and the part of it
  on the host's serial path.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time

import run  # noqa: E402  (benchmark/run.py: paths and caches first)

KINDS = ("prefill_tick", "decode_burst")


def _kids(children, span, name):
    return next((s for s in children.get(span.id, ()) if s.name == name),
                None)


def _body(children, tick):
    return next((s for s in children.get(tick.id, ()) if s.name in KINDS),
                None)


def clocks(ticks, children, gaps) -> dict:
    """The two clocks over each maximal run of consecutive counted ticks
    (module docstring)."""
    follow = {id(c) for _, c in gaps}
    runs = []
    for s, counted in ticks:
        if counted and "work_ms" in s.attrs:
            if id(s) in follow:
                runs[-1].append(s)
            else:
                runs.append([s])
    worst, dev_sum, host_sum = 0.0, 0.0, 0.0
    for r in runs:
        dev = 1e-3 * (sum(s.attrs["work_ms"] for s in r)
                      + sum(s.attrs["gap_ms"] for s in r[1:]))
        first = _kids(children, _body(children, r[0]), "enqueue")
        last = _kids(children, _body(children, r[-1]), "fetch")
        host = 1e-9 * (last.t1 - first.t0)
        dev_sum, host_sum = dev_sum + dev, host_sum + host
        worst = max(worst, abs(host - dev) / host)
    return dict(runs=len(runs), ticks=sum(len(r) for r in runs),
                device_s=dev_sum, host_s=host_sum,
                largest_rel_diff=worst)


def gap_split(gaps, children) -> dict:
    """Each counted gap on the host's clock (module docstring), in ms a
    gap."""
    parts = dict(device_gap=0.0, emit=0.0, between_ticks=0.0, admit=0.0,
                 prepare=0.0, rest_of_ticks=0.0, fetch_tail=0.0)
    longest = dict(device_gap=0.0, fetch_tail=0.0)
    after = {}                  # fetch tails by the kind of the tick before
    for p, c in gaps:
        pb, cb = _body(children, p), _body(children, c)
        fetch, emit = _kids(children, pb, "fetch"), _kids(children, pb, "emit")
        admit = _kids(children, c, "admit")
        prep, enq = _kids(children, cb, "prepare"), _kids(children, cb,
                                                          "enqueue")
        host = 1e-6 * (enq.t0 - fetch.t1)
        named = {"emit": emit.t1 - emit.t0, "between_ticks": c.t0 - p.t1,
                 "admit": admit.t1 - admit.t0, "prepare": prep.t1 - prep.t0}
        for k, v in named.items():
            parts[k] += 1e-6 * v
        parts["rest_of_ticks"] += host - 1e-6 * sum(named.values())
        parts["device_gap"] += c.attrs["gap_ms"]
        parts["fetch_tail"] += c.attrs["gap_ms"] - host
        longest["device_gap"] = max(longest["device_gap"], c.attrs["gap_ms"])
        longest["fetch_tail"] = max(longest["fetch_tail"],
                                    c.attrs["gap_ms"] - host)
        after.setdefault(p.attrs["kind"], []).append(c.attrs["gap_ms"] - host)
    n = max(1, len(gaps))
    return dict(gaps=len(gaps), **{k + "_ms": v / n for k, v in parts.items()},
                **{"longest_" + k + "_ms": v for k, v in longest.items()},
                fetch_tail_after_ms={k: statistics.fmean(v)
                                     for k, v in after.items()})


def idle_by_span(events, trace_ranges) -> dict:
    """bench/trace.py's idle split with the program's spans standing in for
    the harness's; ``trace_ranges``: the family's model ranges, skipped as
    the run's own summary skips them."""
    from torch.autograd import DeviceType

    from bench import trace as tracing

    class Ev:
        def __init__(self, e, name):
            self.name, self.time_range = name, e.time_range
            self.device_type = e.device_type
            self.is_user_annotation = getattr(e, "is_user_annotation", False)

    prefix = "quest."
    evs = []
    for e in events:
        if e.name.startswith(tracing.SPAN_PREFIX):
            continue
        if e.name.startswith(prefix):
            if e.device_type == DeviceType.CPU:
                evs.append(Ev(e, tracing.SPAN_PREFIX + e.name[len(prefix):]))
            continue
        evs.append(e)
    d = tracing.summarize(evs, trace_ranges)
    if d is None:
        return {}
    return dict(window_s=d["window_s"], busy_s=d["busy_s"],
                idle_s={k: g[0] for k, g in d["gaps"].items()},
                pieces={k: g[1] for k, g in d["gaps"].items()})


def tick_ranges(events, ticks) -> dict:
    """Each profiled tick's ``quest.tick`` range against its span: the
    largest difference in us, as read and at the rate of the profiler's
    clock against ``perf_counter`` (from the first and last ranges'
    starts), and that rate's difference in ppm."""
    from torch.autograd import DeviceType
    prof = [e.time_range for e in events
            if e.name == "quest.tick" and e.device_type == DeviceType.CPU]
    spans = [s for s, counted in ticks if not counted]
    n = min(len(prof), len(spans))
    rate = 1.0
    if n > 1:
        rate = ((prof[n - 1].start - prof[0].start)
                / ((spans[n - 1].t0 - spans[0].t0) / 1e3))
    diffs = [abs(p.elapsed_us() - (s.t1 - s.t0) / 1e3)
             for p, s in zip(prof, spans)]
    at_rate = [abs(p.elapsed_us() / rate - (s.t1 - s.t0) / 1e3)
               for p, s in zip(prof, spans)]
    return dict(ranges=len(prof), spans=len(spans),
                diffs_us=[round(d, 2) for d in diffs],
                largest_diff_us=max(diffs, default=None),
                profiler_rate_ppm=1e6 * (rate - 1.0),
                largest_diff_us_at_rate=max(at_rate, default=None))


def requests(rec, rcd) -> dict:
    from bench.readers import percentile
    at = {}
    for e in rcd.events():
        at.setdefault((e.name, e.uid), e.t)
    wait, answer, ttft = [], [], []
    for st in rec.window_requests():
        s, a, f = (at.get((n, st.uid)) for n in ("submit", "admit",
                                                  "first_token"))
        if None in (s, a, f):
            continue
        wait.append(1e-6 * (a - s))
        answer.append(1e-6 * (f - a))
        ttft.append(1e-6 * (f - s))

    def p(v):
        return dict(p50=percentile(v, 50), p90=percentile(v, 90),
                    mean=statistics.fmean(v) if v else None)
    return dict(n=len(ttft), ttft_ms=p(ttft), queue_wait_ms=p(wait),
                admit_to_first_token_ms=p(answer))


def recorder_cost(device, reps=500, steps=16) -> dict:
    """Host us of the recorder's work for one decode tick (medians): all
    of it, and the part on the serial path (all but the marks after the
    first and the settle, which run while the device works)."""
    import torch

    from quest_tpu_torch.utils.trace import DeviceMarks, Recorder
    rcd, marks = Recorder(), DeviceMarks(device)
    cuda = torch.device(device).type == "cuda"
    total, serial = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        with rcd.span("tick", 1) as t:
            with rcd.span("admit") as a:
                a.attrs["admitted"] = []
            with rcd.span("decode_burst"):
                with rcd.span("prepare"):
                    pass
                with rcd.span("enqueue"):
                    marks.mark()
                    t1 = time.perf_counter()
                    for _ in range(steps + 1):
                        marks.mark()
                    marks.settle()
                    t2 = time.perf_counter()
                with rcd.span("fetch"):
                    if cuda:
                        torch.cuda.synchronize()
                t3 = time.perf_counter()
                with rcd.span("emit"):
                    for uid in range(4):
                        rcd.event("finish", uid)
            t.attrs.update(kind="decode", rows=8, steps=steps, hit_tokens=0,
                           queue=0, free_blocks=[0], work_left=True)
            marks.read(t.attrs)
        t4 = time.perf_counter()
        serial.append((t1 - t0) + (t4 - t3))
        total.append((t4 - t0) - (t3 - t2))
    return dict(device=str(device),
                us_a_tick=1e6 * statistics.median(total),
                serial_us_a_tick=1e6 * statistics.median(serial))


def report(rec, events, trace_ranges, result) -> dict:
    from bench import program_trace
    rcd = program_trace.recorder()
    ticks = program_trace.window_ticks(rec, rcd) or []
    spans = rcd.spans()
    children = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    gaps = program_trace.counted_gaps(ticks)
    kinds = {}
    for s, counted in ticks:
        k = kinds.setdefault(str(s.attrs.get("kind")), [0, 0])
        k[0] += 1
        k[1] += counted
    t_open, t_close = rec.t_open * 1e9, rec.t_close * 1e9
    free = [sum(s.attrs["free_blocks"]) for s, _ in ticks]
    ops = (result.get("breakdown") or {}).get("device_ops", [])
    return dict(
        ticks=dict(by_kind=kinds, counted_gaps=len(gaps),
                   tick_gap_share=program_trace.tick_gap_share(rec, rcd),
                   decode_step_device_ms=program_trace.decode_step_device_ms(
                       rec, rcd),
                   prefill_tick_device_ms=(
                       program_trace.prefill_tick_device_ms(rec, rcd))),
        clocks=clocks(ticks, children, gaps) if ticks else None,
        gaps=gap_split(gaps, children),
        idle_by_span=(idle_by_span(events, trace_ranges) if events
                      else None),
        tick_ranges=tick_ranges(events, ticks) if events else None,
        requests=requests(rec, rcd),
        pool=dict(least_free_blocks=min(free, default=None),
                  pool_blocks=rec.engine.get("pool_blocks")),
        captures=dict(in_window=sum(t_open <= s.t1 <= t_close
                                    for s in spans if s.name == "capture"),
                      kept=sum(s.name == "capture" for s in spans)),
        ring=dict(capacity=rcd.capacity, kept=len(rcd.entries()),
                  dropped=rcd.dropped,
                  dropped_in_window=rcd.dropped_until >= t_open),
        device_ops_quest=[n for n, _ in ops if n.startswith("quest.")],
        gc=gc.get_stats())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from bench import trace as tracing

    kept = {}

    class KeptCell(run.Cell):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept["rec"] = self.rec

    summarize = tracing.summarize

    def keep_events(events, extra_skip=()):
        kept["events"], kept["ranges"] = list(events), extra_skip
        return summarize(events, extra_skip)

    run.Cell, tracing.summarize = KeptCell, keep_events
    result, compared, info = run.run_cell(args.workload, args.seed,
                                          args.seconds, True, args.device)
    rep = report(kept["rec"], kept.get("events"), kept.get("ranges", ()),
                 result)
    rep["cost"] = recorder_cost(args.device)
    print(json.dumps(dict(trace_report=rep)), flush=True)
    print(json.dumps(dict(info=info)), flush=True)
    result["compared"] = compared
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
