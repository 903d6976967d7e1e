"""Profiled text generation (counterpart of ``scripts/profile_textgen.py``,
the reference's ``torch.profiler`` run).

``torch.profiler`` with a wait/warmup/active schedule over passes of
prefill + N greedy decode steps: the first pass builds the kernels
outside the trace, the second warms the profiler up, the third is
traced. The Chrome trace goes to ``--trace-dir`` (open it in Perfetto or
``chrome://tracing``); the script prints, for each of the model's trace
ranges (``models/llama.py:TRACE_RANGES``, the JAX model's
``jax.named_scope`` names), its calls, host ms and the device ms of the
device ops inside its spans on the device timeline, then the top device
ops.

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


def range_times(events) -> dict:
    """Each trace range among ``prof.events()``: calls, host ms, and the
    device ms of the ops inside its ``gpu_user_annotation`` spans (the
    device timeline's range spans; ranges do not nest and one stream
    runs them in order, so a device op belongs to the span that holds
    its start) beside the spans' own ms, idle gaps included."""
    from torch.autograd import DeviceType

    from quest_tpu_torch.models.llama import TRACE_RANGES
    out = {name: dict(calls=0, host_ms=0.0, device_ms=0.0, span_ms=0.0)
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
    for op in device_ops(events):
        i = bisect.bisect_right(starts, op.time_range.start) - 1
        if i >= 0 and op.time_range.start < spans[i][1]:
            out[spans[i][2]]["device_ms"] += op.time_range.elapsed_us() / 1e3
    return {k: v for k, v in out.items() if v["calls"]}


def run_profile_textgen(cfg, params, args) -> dict:
    """Profiles prefill + ``args.decode_tokens`` decode steps of ``cfg``
    over ``params`` on ``args.device``; returns the JSON dict (ranges,
    top device ops, the trace's path)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from quest_tpu_torch.config import QuestConfig
    from quest_tpu_torch.engine.engine import QuestEngine
    from quest_tpu_torch.ops.utils import resolve_device

    dev = resolve_device(args.device)
    ctx = args.ctx if dev.type == "cuda" else min(args.ctx, 512)
    quest = QuestConfig(page_size=16, token_budget=args.token_budget,
                        max_seq_len=ctx + args.decode_tokens + 16)
    engine = QuestEngine(cfg, quest, params, device=dev)
    prompt = np.random.default_rng(0).integers(
        1, cfg.vocab_size, size=ctx).astype(np.int32).tolist()

    def generate():
        engine.clear()
        logits = engine.prefill([prompt])
        tok = int(np.argmax(logits[0]))
        for _ in range(args.decode_tokens):
            logits = engine.decode([tok])
            tok = int(np.argmax(logits[0]))

    os.makedirs(args.trace_dir, exist_ok=True)
    trace = os.path.join(args.trace_dir, "profile_textgen.json")
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # wait: the kernels build outside the trace; warmup: the profiler's
    # own start-up is discarded; active: the traced pass.
    with profile(activities=activities,
                 schedule=schedule(wait=1, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(trace)) as prof:
        for _ in range(3):
            generate()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            prof.step()
    ranges = range_times(prof.events())
    ops = sorted(device_ops(prof.key_averages()),
                 key=lambda e: -e.self_device_time_total)
    top = [dict(name=e.key[:90], count=e.count,
                device_ms=e.self_device_time_total / 1e3) for e in ops[:10]]
    print(f"{'range':20s} {'calls':>6s} {'host ms':>9s} {'device ms':>10s}")
    for name, r in sorted(ranges.items(), key=lambda kv: -kv[1]["device_ms"]):
        print(f"{name:20s} {r['calls']:6d} {r['host_ms']:9.3f} "
              f"{r['device_ms']:10.3f}")
    print("top device ops:")
    for t in top:
        print(f"  {t['device_ms']:9.3f} ms  x{t['count']:5d}  {t['name']}")
    print(f"trace written to {trace} (open in Perfetto or chrome://tracing)")
    return {"preset": args.preset, "layers": cfg.num_layers,
            "ctx": ctx, "decode_tokens": args.decode_tokens, "trace": trace,
            "device_ms": sum(e.self_device_time_total for e in ops) / 1e3,
            "device_ops": sum(e.count for e in ops), "ranges": ranges,
            "top_device_ops": top}


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
