"""Kernel-level benchmark of the decode pipeline's stages (counterpart of
``scripts/bench_kernels.py``, the NVBench analogue).

Each stage runs at the JAX script's shapes and is reported with the same
bytes-moved (or FLOP) accounting, so its rate can be set against the
card's peak (3.35 TB/s HBM, 989 TFLOP/s dense bf16 on the H100). On the
card every stage is timed by ``utils/benchmarking.py:Timer`` (CUDA
events, L2 flushed between launches; ``--iters`` timed launches after
three untimed ones); with ``--device cpu`` the plain versions are timed by the
host clock.

Stages: ``estimate`` (``page_scores`` over the logical metadata),
``topk`` (``select_pages``), ``sparse`` (the sparse decode kernel over the
selected pages), ``dense`` (the dense decode kernel over the context),
``append`` (``append_decode_at`` at a fixed position), ``prefill`` (a
2048-token chunk at the end of the context) and ``pipeline`` (estimate ->
top-k -> sparse). The JSON line holds each stage's microseconds under the
JAX script's names.

    python -m quest_tpu_torch.scripts.bench_kernels [--ctx 32768]
        [--budget 2048] [--heads 32] [--kv-heads 32] [--stages all|...]
    python -m quest_tpu_torch.scripts.bench_kernels --device cpu \\
        --ctx 2048 --budget 256 --heads 4 --kv-heads 2          # smoke
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import torch

WARMUP = 3                       # untimed calls before a stage's timed ones
STAGES = ("estimate", "topk", "sparse", "dense", "append", "prefill",
          "pipeline")
# Stage -> the JSON key of the JAX script.
RESULT_KEYS = {"estimate": "estimate", "topk": "topk",
               "sparse": "sparse_attn", "dense": "dense_attn",
               "append": "append_decode", "prefill": "prefill",
               "pipeline": "sparse_pipeline"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", type=int, default=32768)
    ap.add_argument("--budget", type=int, default=2048)
    ap.add_argument("--page", type=int, default=16)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=32)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--stages", type=str, default="all")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed launches a stage (the median is reported), "
                         f"after {WARMUP} untimed")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def stage_bytes(B, Hkv, D, page, ctx, budget_pages, max_pages,
                bpe=2) -> dict:
    """Bytes each stage must move, the JAX script's accounting (bf16)."""
    meta = 2 * B * Hkv * max_pages * D * bpe
    pages = 2 * B * Hkv * budget_pages * page * D * bpe
    return {"estimate": meta, "topk": B * Hkv * max_pages * 4,
            "sparse": pages, "dense": 2 * B * Hkv * ctx * D * bpe,
            "append": 2 * B * Hkv * (page + 2) * D * bpe,
            "pipeline": meta + pages}


def prefill_flops(B, Hq, D, ctx, chunk) -> float:
    """Two matmuls x 2 FLOPs a MAC x chunk x the mean causal span x D, a
    head: a chunk at the end of the context attends to all of it."""
    return 2 * 2 * B * Hq * chunk * (ctx - chunk / 2) * D


class HostTimer:
    """Median host-clock ms of ``fn`` (the plain versions on the CPU)."""

    def __call__(self, fn, iters, warmup):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)


def stage_kernels():
    """Stage -> the kernel wrapper it launches (None: plain PyTorch ops)."""
    from quest_tpu_torch.ops.dense_decode import dense_decode_attention
    from quest_tpu_torch.ops.prefill import prefill_attention
    from quest_tpu_torch.ops.sparse_decode import sparse_decode_attention
    return {"estimate": None, "topk": None, "sparse": sparse_decode_attention,
            "dense": dense_decode_attention, "append": None,
            "prefill": prefill_attention, "pipeline": sparse_decode_attention}


def run_bench_kernels(args, detail=None) -> dict:
    """Runs the stages of ``args`` (see :func:`parse_args`); returns
    {JAX stage name: us}. ``detail``, if a dict, receives each stage's
    bytes or FLOPs, rate, kernel launches and timed calls."""
    from quest_tpu_torch.config import ModelConfig, QuestConfig
    from quest_tpu_torch.kv.paged_kv import (append_decode_at,
                                             append_prefill_at, init_cache)
    from quest_tpu_torch.ops.dense_decode import dense_decode_attention
    from quest_tpu_torch.ops.estimate import page_scores
    from quest_tpu_torch.ops.prefill import prefill_attention
    from quest_tpu_torch.ops.sparse_decode import sparse_decode_attention
    from quest_tpu_torch.ops.topk import select_pages
    from quest_tpu_torch.ops.utils import resolve_device

    asked = set(args.stages.split(","))
    if asked - set(STAGES) - {"all"}:
        raise SystemExit(f"unknown stages {sorted(asked - set(STAGES))}; "
                         f"known: {STAGES}")
    want = STAGES if "all" in asked else [s for s in STAGES if s in asked]
    dev = resolve_device(args.device)
    B, Hq, Hkv, D = args.batch, args.heads, args.kv_heads, args.head_dim
    page, CTX, BUDGET = args.page, args.ctx, args.budget
    model = ModelConfig(num_heads=Hq, num_kv_heads=Hkv, head_dim=D)
    quest = QuestConfig(page_size=page, token_budget=BUDGET, max_seq_len=CTX)
    S, P = quest.page_budget, quest.max_pages
    sm = 1.0 / math.sqrt(D)
    log(f"device={dev} B={B} Hq={Hq} Hkv={Hkv} D={D} ctx={CTX} pages={P} "
        f"budget={BUDGET} ({S} page slots)")

    gen = torch.Generator(device=dev).manual_seed(0)
    cache = init_cache(model, quest, batch_size=B, num_layers=1, device=dev)
    kw = dict(layer=0, block_tab=cache.block_tab,
              block_pages=cache.block_pages)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.3

    append_prefill_at(cache, 0, normal(B, CTX, Hkv, D), normal(B, CTX, Hkv, D))
    cache.seq_lens.fill_(CTX)
    seq = cache.seq_lens.clone()
    view = cache.layer(0)                # logical metadata, as JAX times it
    q0 = normal(B, Hq, D)
    scores0 = page_scores(q0, view.k_max, view.k_min)
    idx0, nv0 = select_pages(scores0, seq, page, S)

    nbytes = stage_bytes(B, Hkv, D, page, CTX, S, P)
    CHUNK = min(2048, CTX)
    qp = normal(B, CHUNK, Hq, D)
    offs = torch.full((B,), CTX - CHUNK, dtype=torch.int32, device=dev)
    kv1 = q0[:, :Hkv, :].contiguous()

    def pipeline():
        s = page_scores(q0, view.k_max, view.k_min)
        idx, nv = select_pages(s, seq, page, S)
        return sparse_decode_attention(q0, cache.kv_pages, idx, nv, seq,
                                       sm_scale=sm, **kw)

    fns = {
        "estimate": lambda: page_scores(q0, view.k_max, view.k_min),
        "topk": lambda: select_pages(scores0, seq, page, S),
        "sparse": lambda: sparse_decode_attention(
            q0, cache.kv_pages, idx0, nv0, seq, sm_scale=sm, **kw),
        "dense": lambda: dense_decode_attention(
            q0, cache.kv_pages, seq, sm_scale=sm, **kw),
        # seq_lens is not advanced: every call writes the same position.
        "append": lambda: append_decode_at(cache, 0, kv1, kv1),
        "prefill": lambda: prefill_attention(qp, cache.kv_pages, offs, seq,
                                             sm_scale=sm, **kw),
        "pipeline": pipeline,
    }
    if dev.type == "cuda":
        from quest_tpu_torch.utils.benchmarking import Timer
        timer = Timer()
    else:
        timer = HostTimer()
    kernels = stage_kernels()
    results = {}
    for name in want:
        kernel = kernels[name]
        if kernel is not None:
            kernel.launches = 0
        ms = timer(fns[name], iters=args.iters, warmup=WARMUP)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = ms * 1e-3
        row = dict(us=ms * 1e3, calls=args.iters + WARMUP,
                   launches=kernel.launches if kernel is not None else 0,
                   kernel=kernel.__name__ if kernel is not None else None)
        if name == "prefill":
            flops = prefill_flops(B, Hq, D, CTX, CHUNK)
            row.update(flops=flops, tflops=flops / t / 1e12)
            log(f"{'prefill':16s} {t * 1e6:9.1f} us   {flops / t / 1e12:7.1f} "
                f"TFLOP/s (chunk {CHUNK} @ end of {CTX})")
        else:
            row.update(bytes=nbytes[name], gbps=nbytes[name] / t / 1e9)
            log(f"{RESULT_KEYS[name]:16s} {t * 1e6:9.1f} us   "
                f"{nbytes[name] / t / 1e9:7.1f} GB/s "
                f"({nbytes[name] / 1e6:.1f} MB)")
        results[RESULT_KEYS[name]] = round(ms * 1e3, 1)
        if detail is not None:
            detail[RESULT_KEYS[name]] = row
    return results


def main(argv=None):
    args = parse_args(argv)
    out = run_bench_kernels(args)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
