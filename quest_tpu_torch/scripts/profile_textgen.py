"""Profiled text generation (counterpart of ``scripts/profile_textgen.py``,
the reference's ``torch.profiler`` run).

``torch.profiler`` with a wait/warmup/active schedule over passes of
prefill + N greedy decode steps, run under ``engine.graphs.eager()``: the
trace ranges open on the host, so a replayed CUDA graph has none. The
first pass builds the kernels outside the trace, the second warms the
profiler up, the third is traced. The Chrome trace goes to
``--trace-dir`` (open it in Perfetto or ``chrome://tracing``); the
script prints, for each of the model's trace ranges
(``models/llama.py:TRACE_RANGES``, the JAX model's ``jax.named_scope``
names), its calls, host ms and the device ms of the device ops inside
its spans on the device timeline (split between the prefill pass and
the decode steps, and by device op), then the top device ops. Then the N
decode steps run as the engine runs them (captured once, replayed) in a
second profile, and it prints their device ms and device ops a step
beside the eager ones.

    python -m quest_tpu_torch.scripts.profile_textgen --preset llama31-8b \\
        --layers 4 --ctx 8192 --trace-dir build/quest_trace
    python -m quest_tpu_torch.scripts.profile_textgen --preset tiny \\
        --device cpu --decode-tokens 2                          # smoke
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import os

import numpy as np
import torch

from quest_tpu_torch.utils.cli import PRESETS


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="llama31-8b", choices=sorted(PRESETS))
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--ctx", type=int, default=8192)
    ap.add_argument("--token-budget", type=int, default=2048)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--trace-dir", type=str, default="build/quest_trace")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def device_ops(events):
    """The device's own ops among profiler events (kernels, memcpys,
    memsets). The trace ranges also come back as device events
    (``gpu_user_annotation`` spans over their kernels) and are left out,
    so no op counts twice."""
    from torch.autograd import DeviceType

    from quest_tpu_torch.models.llama import TRACE_RANGES
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key not in TRACE_RANGES]


# Ranges that only a decode step opens: the first of their spans on the
# device timeline ends the prefill pass.
DECODE_RANGES = ("append_kv_decode", "quest_fused_decode", "quest_estimate",
                 "quest_topk", "quest_sparse_attn", "dense_decode_attn")


def range_times(events) -> dict:
    """Each trace range among ``prof.events()``: calls, host ms, and the
    device ms of the ops inside its ``gpu_user_annotation`` spans (the
    device timeline's range spans; ranges do not nest and one stream
    runs them in order, so a device op belongs to the span that holds
    its start) beside the spans' own ms, idle gaps included. The device
    ms is also split between the prefill pass and the decode steps
    (``prefill_device_ms``, ``decode_device_ms``: before and after the
    first span of a :data:`DECODE_RANGES` range) and by device op
    (``ops``: op name -> [count, device ms])."""
    from torch.autograd import DeviceType

    from quest_tpu_torch.models.llama import TRACE_RANGES
    out = {name: dict(calls=0, host_ms=0.0, device_ms=0.0, span_ms=0.0,
                      prefill_device_ms=0.0, decode_device_ms=0.0, ops={})
           for name in TRACE_RANGES}
    spans = []
    for e in events:
        if e.key not in TRACE_RANGES:
            continue
        row = out[e.key]
        if e.device_type == DeviceType.CPU:
            row["calls"] += 1
            row["host_ms"] += e.time_range.elapsed_us() / 1e3
        else:
            row["span_ms"] += e.time_range.elapsed_us() / 1e3
            spans.append((e.time_range.start, e.time_range.end, e.key))
    spans.sort()
    starts = [s[0] for s in spans]
    decode_start = min((s for s, _, k in spans if k in DECODE_RANGES),
                       default=float("inf"))
    for op in device_ops(events):
        i = bisect.bisect_right(starts, op.time_range.start) - 1
        if i >= 0 and op.time_range.start < spans[i][1]:
            row = out[spans[i][2]]
            ms = op.time_range.elapsed_us() / 1e3
            row["device_ms"] += ms
            row["decode_device_ms" if op.time_range.start >= decode_start
                else "prefill_device_ms"] += ms
            n_ms = row["ops"].setdefault(op.key[:90], [0, 0.0])
            n_ms[0] += 1
            n_ms[1] += ms
    return {k: v for k, v in out.items() if v["calls"]}


def run_profile_textgen(cfg, params, args) -> dict:
    """Profiles prefill + ``args.decode_tokens`` decode steps of ``cfg``
    over ``params`` on ``args.device``; returns the JSON dict (ranges,
    top device ops, the trace's path)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from quest_tpu_torch.config import QuestConfig
    from quest_tpu_torch.engine.engine import QuestEngine
    from quest_tpu_torch.engine.graphs import eager
    from quest_tpu_torch.ops.utils import resolve_device

    dev = resolve_device(args.device)
    ctx = args.ctx if dev.type == "cuda" else min(args.ctx, 512)
    quest = QuestConfig(page_size=16, token_budget=args.token_budget,
                        max_seq_len=ctx + args.decode_tokens + 16)
    engine = QuestEngine(cfg, quest, params, device=dev)
    prompt = np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=ctx).astype(np.int32).tolist()

    def prefill():
        engine.clear()
        return int(np.argmax(engine.prefill([prompt])[0]))

    def decode(tok):
        for _ in range(args.decode_tokens):
            tok = int(np.argmax(engine.decode([tok])[0]))

    def generate():
        decode(prefill())

    os.makedirs(args.trace_dir, exist_ok=True)
    trace = os.path.join(args.trace_dir, "profile_textgen.json")
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # wait: the kernels build outside the trace; warmup: the profiler's
    # own start-up is discarded; active: the traced pass.
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with eager(), profile(
            activities=activities,
            schedule=schedule(wait=1, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(trace)) as prof:
        for _ in range(3):
            generate()
            sync()
            prof.step()
    ranges = range_times(prof.events())
    ops = sorted(device_ops(prof.key_averages()),
                 key=lambda e: -e.self_device_time_total)
    # The decode steps as the engine runs them: captured at first use,
    # then replayed under the profiler.
    generate()
    tok = prefill()
    sync()
    with profile(activities=activities) as gprof:
        decode(tok)
        sync()
    gops = device_ops(gprof.key_averages())
    graph = dict(device_ms=sum(e.self_device_time_total for e in gops) / 1e3,
                 device_ops=sum(e.count for e in gops))
    n = max(args.decode_tokens, 1)
    top = [dict(name=e.key[:90], count=e.count,
                device_ms=e.self_device_time_total / 1e3) for e in ops[:10]]
    print(f"{'range':20s} {'calls':>6s} {'host ms':>9s} {'device ms':>10s} "
          f"{'prefill':>9s} {'decode':>9s}")
    for name, r in sorted(ranges.items(), key=lambda kv: -kv[1]["device_ms"]):
        print(f"{name:20s} {r['calls']:6d} {r['host_ms']:9.3f} "
              f"{r['device_ms']:10.3f} {r['prefill_device_ms']:9.3f} "
              f"{r['decode_device_ms']:9.3f}")
        for op, (count, ms) in sorted(r["ops"].items(),
                                      key=lambda kv: -kv[1][1])[:8]:
            print(f"    {ms:9.3f} ms  x{count:5d}  {op}")
    print("top device ops:")
    for t in top:
        print(f"  {t['device_ms']:9.3f} ms  x{t['count']:5d}  {t['name']}")
    print(f"decode steps as the engine runs them (captured): "
          f"{graph['device_ms'] / n:.3f} device ms and "
          f"{graph['device_ops'] / n:.1f} device ops a step")
    print(f"trace written to {trace} (open in Perfetto or chrome://tracing)")
    return {"preset": args.preset, "layers": cfg.num_layers,
            "ctx": ctx, "decode_tokens": args.decode_tokens, "trace": trace,
            "device_ms": sum(e.self_device_time_total for e in ops) / 1e3,
            "device_ops": sum(e.count for e in ops), "ranges": ranges,
            "top_device_ops": top,
            "graph_decode_device_ms_per_step": graph["device_ms"] / n,
            "graph_decode_device_ops_per_step": graph["device_ops"] / n}


def main(argv=None):
    args = parse_args(argv)
    from quest_tpu_torch.models.llama import init_params
    from quest_tpu_torch.ops.utils import resolve_device
    cfg = dataclasses.replace(PRESETS[args.preset](), num_layers=args.layers)
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    out = run_profile_textgen(cfg, params, args)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
