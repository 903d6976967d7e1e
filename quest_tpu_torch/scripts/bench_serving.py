"""Continuous-batching serving throughput benchmark (counterpart of
``scripts/bench_serving.py``).

Many requests stream through a fixed-capacity slot pool
(``engine/scheduler.py``); reports the aggregate generated tokens/s,
requests/s and the prefix cache's hits. With ``--shared-prefix`` every
prompt starts with the same tokens, and the run is repeated with the
prefix cache off and on in turns (``--ab-rounds``) for the ratio of
medians. ``--sweep`` runs share ratios {25, 50, 75, 90%} x prompt
lengths {2K, 8K}, one JSON line a cell.

Each engine serves two warm-up batches before its timed run (the first
builds the kernels and fills the tensor-map caches and, with a shared
prefix, publishes it; the second then hits it), and its hit counters are
reset so the report covers the timed run only.

    python -m quest_tpu_torch.scripts.bench_serving --preset llama31-8b \\
        --layers 4 --max-batch 4 --requests 16 --prompt-len 1024 \\
        --gen-len 64
    python -m quest_tpu_torch.scripts.bench_serving --preset tiny \\
        --device cpu --requests 4 --prompt-len 64 --gen-len 4 \\
        --max-seq-len 256 --block-pages 2 --shared-prefix 32   # smoke
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from quest_tpu_torch.utils.cli import PRESETS


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="llama31-8b", choices=sorted(PRESETS))
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--gen-len", type=int, default=64)
    ap.add_argument("--token-budget", type=int, default=2048)
    ap.add_argument("--max-seq-len", type=int, default=8192)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of common prompt prefix across all "
                         "requests (exercises the prefix cache; also "
                         "measured with the cache off for the ratio)")
    ap.add_argument("--ab-rounds", type=int, default=3,
                    help="uncached/cached repeats in turns for the "
                         "prefix-cache ratio (medians)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--block-pages", type=int, default=64,
                    help="pool allocation granularity; prefix sharing is "
                         "block-aligned, so block_pages*page_size tokens "
                         "is the hit granularity")
    ap.add_argument("--sweep", action="store_true",
                    help="prefix-cache sweep: share ratios {25,50,75,90%%} "
                         "x prompt lengths {2K,8K}, one JSON line a cell")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def run_bench_serving(cfg, params, args) -> list:
    """The cells of ``args`` (one, or the sweep's) served by
    ``ContinuousBatchingEngine`` over ``params`` on ``args.device``;
    prints each cell's JSON line as it completes and returns the
    dicts."""
    from quest_tpu_torch.config import QuestConfig
    from quest_tpu_torch.engine.scheduler import (ContinuousBatchingEngine,
                                                  Request)
    from quest_tpu_torch.ops.utils import resolve_device

    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    quest = QuestConfig(page_size=args.page_size,
                        token_budget=args.token_budget,
                        max_seq_len=args.max_seq_len,
                        block_pages=args.block_pages)
    rng = np.random.default_rng(0)

    def make_reqs(n, uid0, prompt_len, shared_prefix, shared):
        tail = prompt_len - shared_prefix
        return [Request(uid=uid0 + i,
                        prompt=shared + rng.integers(
                            1, cfg.vocab_size, size=tail).tolist(),
                        max_new_tokens=args.gen_len)
                for i in range(n)]

    def run_engine(prefix_entries, prompt_len, shared_prefix, shared,
                   uid_base):
        engine = ContinuousBatchingEngine(
            cfg, quest, params, max_batch=args.max_batch,
            prefill_bucket=min(prompt_len, 512),
            prefix_cache_entries=prefix_entries, device=dev)
        engine.run(make_reqs(args.max_batch, 10000, prompt_len,
                             shared_prefix, shared))
        if prefix_entries and shared_prefix:
            engine.run(make_reqs(args.max_batch, 20000, prompt_len,
                                 shared_prefix, shared))
        engine.prefix_hits = engine.prefix_hit_tokens = 0
        reqs = make_reqs(args.requests, uid_base, prompt_len,
                         shared_prefix, shared)
        sync()
        t0 = time.perf_counter()
        outs = engine.run(reqs)
        sync()
        dt = time.perf_counter() - t0
        stats = (engine.prefix_hits, engine.prefix_hit_tokens)
        del engine
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return dt, outs, stats

    def run_cell(prompt_len, shared_prefix):
        shared = rng.integers(1, cfg.vocab_size, size=shared_prefix).tolist()
        dt, outs, (hits, hit_tokens) = run_engine(64, prompt_len,
                                                  shared_prefix, shared, 0)
        total_tokens = sum(len(v) for v in outs.values())
        block_tokens = args.block_pages * args.page_size
        result = {
            "preset": args.preset, "layers": args.layers,
            "max_batch": args.max_batch, "requests": args.requests,
            "prompt_len": prompt_len, "gen_len": args.gen_len,
            "shared_prefix": shared_prefix,
            "shared_blocks": shared_prefix // block_tokens,
            "block_tokens": block_tokens,
            "wall_s": round(dt, 2),
            "generated_tokens": total_tokens,
            "tokens_per_s": round(total_tokens / dt, 1),
            "requests_per_s": round(args.requests / dt, 2),
            "prefix_hits": hits,
            "prefix_hit_tokens": hit_tokens,
        }
        if shared_prefix:
            # Repeats in turns, ratio of medians: one cached / uncached
            # pair of seconds-long runs carries the host's variance.
            cached, uncached = [dt], []
            for _ in range(args.ab_rounds):
                uncached.append(run_engine(0, prompt_len, shared_prefix,
                                           shared, 0)[0])
                cached.append(run_engine(64, prompt_len, shared_prefix,
                                         shared, 0)[0])
            med = sorted(cached)[len(cached) // 2]
            med0 = sorted(uncached)[len(uncached) // 2]
            result["wall_s_cached_runs"] = [round(x, 2) for x in cached]
            result["wall_s_no_prefix_cache_runs"] = [round(x, 2)
                                                     for x in uncached]
            result["wall_s_no_prefix_cache"] = round(med0, 2)
            result["prefix_cache_speedup"] = round(med0 / med, 2)
        print(json.dumps(result), flush=True)
        return result

    if not args.sweep:
        return [run_cell(args.prompt_len, args.shared_prefix)]
    # Hits are block-aligned, so low-share short prompts round down to
    # zero shared blocks: the sweep shows that edge.
    return [run_cell(prompt_len, int(prompt_len * ratio))
            for prompt_len in (2048, 8192)
            if prompt_len + args.gen_len <= args.max_seq_len
            for ratio in (0.25, 0.5, 0.75, 0.9)]


def main(argv=None):
    args = parse_args(argv)
    from quest_tpu_torch.models.llama import init_params
    from quest_tpu_torch.ops.utils import resolve_device
    cfg = dataclasses.replace(PRESETS[args.preset](), num_layers=args.layers)
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    return run_bench_serving(cfg, params, args)


if __name__ == "__main__":
    main()
