"""The decode step's launch-bound kernels, timed alone and read in the
captured step, so two trees can be set side by side in one call.

Usage: python -m quest_tpu_torch.exp.step_kernels [--label new] [--steps 16]
       python -m quest_tpu_torch.exp.step_kernels --cpu

Times, under ``utils/benchmarking.py:Timer`` with the memset flush and
with the read flush, each in turns: ``rms_norm`` with its residual at a
decode step's B=2 rows of 4096 and at a prefill chunk of 8192 rows
(bf16), and the decode step's rope and append at the main path's shape
(Llama-3.1-8B's 32 / 8 heads, B=2 at 5000 and 2500 tokens of a
16384-token bf16 pool): ``rotate_qk`` then ``append_decode_at``, and
``rope_append_decode_at`` (the two in one launch) where the package has
it; and ``rms_norm`` at the decode shape in a captured graph of 2L + 1
norms with and without L2 flushed before each (so w comes from DRAM, as
in the step, or from L2: what w's round trip costs). Then it serves
full-width Llama-3.1-8B (random bf16 weights, the
unfused ``QuestConfig``, B=2, prompts of 5000 and 2500 tokens) and reads
its captured decode step: wall ms a step over ``--steps`` replays, and
a profile of 4 replays (each kernel's device us a launch, ``silu_mul``'s
where the package has it, device busy ms and device ops a step).

It calls only what both the tree before the decode step's rope moved
into the append and the trees after it hold, so one call can run it on
both: unpack the older tree's ``quest_tpu_torch`` into ``build/ab_old``,
copy this file into it, and run ``(cd build/ab_old && python -m
quest_tpu_torch.exp.step_kernels --label old)`` and ``python -m
quest_tpu_torch.exp.step_kernels --label new`` in turns (old, new, new,
old). Prints one JSON line last. ``--cpu`` runs the same code on the
plain versions with a tiny model and the host's clock (a smoke run of
the script: no number it prints is a device's).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from quest_tpu_torch.config import QuestConfig, llama31_8b, tiny_test_model

KERNELS = ("rms_norm_kernel", "append_decode_kernel", "rope_kernel",
           "silu_mul_kernel")
PROFILE_STEPS = 4
MARGIN_S = 0.25          # idle inside the profiled window's edges


def log(*a):
    print(*a, file=sys.stderr, flush=True)


class HostTimer:
    """Median host-clock ms of ``fn`` (``--cpu``)."""

    kind = "host"

    def __call__(self, fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)


def kernel_rows(dev, cfg, chunk, timers):
    """{row: {flush: [ms a turn]}} of the norm and the rope and append."""
    from quest_tpu_torch.kv import paged_kv
    from quest_tpu_torch.kv.paged_kv import append_decode_at, init_cache
    from quest_tpu_torch.ops.rms_norm import rms_norm
    from quest_tpu_torch.ops.rope import (compute_rope_params, rope_cos_sin,
                                          rotate_qk)
    from quest_tpu_torch.utils.benchmarking import in_turns
    gen = torch.Generator(device=dev).manual_seed(0)
    H, D = cfg.hidden_size, cfg.head_dim
    bf16, eps = torch.bfloat16, cfg.rms_norm_eps

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)
    w = 1 + normal(H)
    norm_in = {T: (normal(2 if T == 1 else 1, T, H),
                   normal(2 if T == 1 else 1, T, H)) for T in (1, chunk)}
    quest = QuestConfig(max_seq_len=16384)
    cache = init_cache(cfg, quest, batch_size=2, num_layers=1, device=dev)
    cache.seq_lens.copy_(torch.tensor([5000, 2500], dtype=torch.int32))
    act = torch.ones(2, dtype=torch.bool, device=dev)
    q = normal(2, cfg.num_heads, D)
    k, v = normal(2, cfg.num_kv_heads, D), normal(2, cfg.num_kv_heads, D)
    inv, ps, att = compute_rope_params(cfg.rope, D)
    cos, sin = rope_cos_sin(cache.seq_lens[:, None], inv.to(dev), ps, att)

    def pair():
        _, ko = rotate_qk(q, k, cos[:, 0], sin[:, 0])
        append_decode_at(cache, 0, ko, v, act)
    fns = {"rms_norm_decode": lambda: rms_norm(norm_in[1][0], w, eps,
                                               residual=norm_in[1][1]),
           f"rms_norm_chunk_{chunk}": lambda: rms_norm(
               norm_in[chunk][0], w, eps, residual=norm_in[chunk][1]),
           "rope_then_append": pair}
    merged = getattr(paged_kv, "rope_append_decode_at", None)
    if merged is not None:
        fns["rope_append"] = lambda: merged(cache, 0, q, k, v, cos, sin, act)
    out = {}
    for timer in timers:
        for name, ms in in_turns(timer, fns).items():
            out.setdefault(name, {})[timer.kind] = ms
    return out


def profiled(run, dev):
    """Device time of ``run()`` by kernel: ({kernel of KERNELS: (launches,
    us)}, device busy us, device ops), from a profile whose window opens
    and closes MARGIN_S away from the run."""
    from torch.profiler import ProfilerActivity, profile

    from quest_tpu_torch.scripts.profile_textgen import device_ops
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        time.sleep(MARGIN_S)
        run()
        time.sleep(MARGIN_S)
    events = device_ops(prof.key_averages())
    per = {}
    for e in events:
        name = next((kn for kn in KERNELS if kn in e.key), None)
        if name is not None:
            c, us = per.get(name, (0, 0.0))
            per[name] = (c + e.count, us + e.self_device_time_total)
    return (per, sum(e.self_device_time_total for e in events),
            sum(e.count for e in events))


def norm_in_graph(dev, cfg):
    """``rms_norm`` at a decode step's shape (B=2, bf16, with the
    residual) in a captured graph of 2L + 1 norms, each over its own
    weight, replayed: us a launch with L2 flushed before each norm (a 256
    MB memset, then x and res rewritten, so that only w comes from DRAM,
    as in the decode step, where gigabytes of layer weights pass between
    two uses of a norm's weight) and without (w in L2 too)."""
    if dev.type != "cuda":
        return {}
    from quest_tpu_torch.ops.rms_norm import rms_norm
    gen = torch.Generator(device=dev).manual_seed(1)
    ws = (1 + torch.randn((2 * cfg.num_layers + 1, cfg.hidden_size),
                          generator=gen, device=dev)).bfloat16()
    x = torch.randn((2, 1, cfg.hidden_size), generator=gen,
                    device=dev).bfloat16()
    r = torch.randn(x.shape, generator=gen, device=dev).bfloat16()
    big = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for name, cold in (("w_in_l2", False), ("w_from_dram", True)):
        def body():
            for w in ws:
                if cold:
                    big.zero_()
                    x.add_(0)
                    r.add_(0)
                rms_norm(x, w, cfg.rms_norm_eps, residual=r)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()                            # builds, warms
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        graph.replay()
        torch.cuda.synchronize()

        def replays():
            for _ in range(PROFILE_STEPS):
                graph.replay()
            torch.cuda.synchronize()
        c, us = profiled(replays, dev)[0]["rms_norm_kernel"]
        out[name] = us / c
        del graph
    return out


def step_reading(dev, cfg, steps):
    """The captured decode step of the unfused engine at B=2: wall ms a
    step over ``steps`` replays, and a profile of PROFILE_STEPS more."""
    from quest_tpu_torch.engine.engine import QuestEngine
    from quest_tpu_torch.models.llama import init_params
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    engine = QuestEngine(cfg, QuestConfig(max_seq_len=16384), params,
                         batch_size=2, device=dev)
    rng = np.random.default_rng(0)
    n = (5000, 2500) if dev.type == "cuda" else (50, 25)
    prompts = [rng.integers(1, cfg.vocab_size, size=m).tolist() for m in n]
    logits = engine.prefill(prompts)
    tk = torch.as_tensor(np.argmax(logits, -1).astype(np.int32), device=dev)

    def run(count):
        nonlocal tk
        for _ in range(count):
            tk = engine._tok_fn(engine.cache, tk)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    run(3)                                    # capture, then replays
    t = time.perf_counter()
    run(steps)
    wall = (time.perf_counter() - t) / steps * 1e3
    per, busy_us, ops = profiled(lambda: run(PROFILE_STEPS), dev)
    return dict(
        wall_ms_per_step=wall, busy_ms_per_step=busy_us / 1e3 / PROFILE_STEPS,
        ops_per_step=ops / PROFILE_STEPS,
        kernels={kn: dict(launches_per_step=c / PROFILE_STEPS,
                          us_per_launch=us / c)
                 for kn, (c, us) in per.items()})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="new")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if args.cpu:
        dev, chunk, timers = torch.device("cpu"), 64, [HostTimer()]
        cfg = tiny_test_model(2)
        card = "cpu (host clock: no device number)"
    else:
        if not torch.cuda.is_available():
            raise SystemExit("step_kernels: no CUDA device; --cpu runs the "
                             "plain versions")
        from quest_tpu_torch.ops import _build
        from quest_tpu_torch.utils.benchmarking import Timer
        _build.build()                  # every kernel, nvcc's in parallel
        dev, chunk, cfg = torch.device("cuda"), 8192, llama31_8b()
        timers = [Timer(), Timer(flush="read")]
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    rows = kernel_rows(dev, cfg, chunk, timers)
    for name, by_flush in rows.items():
        log(f"[{args.label}] {name}: us " + "; ".join(
            f"{k} {' / '.join(f'{x * 1e3:.2f}' for x in v)}"
            for k, v in by_flush.items()))
    del timers
    norm_us = norm_in_graph(dev, cfg)
    if norm_us:
        log(f"[{args.label}] rms_norm in a graph of {2 * cfg.num_layers + 1}"
            f" norms, us a launch: " + ", ".join(
                f"{k} {v:.2f}" for k, v in norm_us.items()))
    step = step_reading(dev, cfg, args.steps)
    log(f"[{args.label}] captured step: wall {step['wall_ms_per_step']:.3f} "
        f"ms, busy {step['busy_ms_per_step']:.3f} ms, "
        f"{step['ops_per_step']:.1f} ops; " + "; ".join(
            f"{k} {v['us_per_launch']:.2f} us x {v['launches_per_step']:.0f}"
            for k, v in step["kernels"].items()) + f"; card {card}")
    out = dict(label=args.label, card=card, timer_ms=rows,
               norm_in_graph_us=norm_us, step=step)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
