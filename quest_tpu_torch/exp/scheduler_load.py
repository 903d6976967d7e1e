"""Sustained throughput of the continuous-batching scheduler.

Usage: python -m quest_tpu_torch.exp.scheduler_load [REQUESTS] [--cpu]
       [--eager]

A queue of REQUESTS (default 16) greedy requests of realistic length
(prompts of 2000-6000 tokens, 128-384 new tokens, drawn from a seed)
is served by ``ContinuousBatchingEngine`` over the full-width
Llama-3.1-8B (32 layers, random bf16 weights) with
``serving_quest_config(16384)`` and bf16 KV: 4 slots, bursts of 8,
prefill chunks of 2048 in buckets of 256, every slot's blocks reserved
(so admission waits only for a slot). The kernels are built and four
short requests served first, so no first-use cost falls in the
measurement. The rates are read over the window in which every slot
stays busy and turns over: from the tick after the first request
finishes to the tick after which the queue is empty (the last refill);
the run stops there. Within the window every slot that finishes is
refilled at the next tick, so the window holds the scheduler's steady
mix of prefill ticks and decode bursts. It prints
the card's name and power limit, then one JSON object: generated
tokens/s over the window (prefill ticks included) and over each third
of its wall time (the spread), ms a decode step, prompt tokens/s over
the prefill ticks, and the share of decode rows that were live.
The scheduler's decode steps run as it runs them, captured once as CUDA
graphs and replayed; ``--eager`` runs them uncaptured
(``engine/graphs.py:eager``). Decode steps are counted at the compiled
steps. ``--cpu`` runs a tiny model on the CPU's plain path instead (a
check of the script, not a measurement).
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from quest_tpu_torch.engine.scheduler import ContinuousBatchingEngine, Request


def make_requests(n: int, prompt_range, new_range, vocab: int,
                  seed: int = 0) -> List[Request]:
    rng = np.random.default_rng(seed)
    return [Request(u, rng.integers(1, vocab, size=int(rng.integers(
        *prompt_range))).tolist(), int(rng.integers(*new_range)))
        for u in range(n)]


def serve_window(eng: ContinuousBatchingEngine, requests: List[Request],
                 sync) -> Dict:
    """Serve ``requests`` until the queue is empty after a tick; the rates
    of the window that opens after the first request finishes (see the
    module's docstring)."""
    written = [0]
    prefill_last = eng.model.prefill_last

    def counted_prefill(cache, toks, new_lens):
        written[0] += int(new_lens.sum())
        return prefill_last(cache, toks, new_lens)

    def decode_calls():
        return eng._tok_fn.calls + eng._sample_fn.calls

    eng.model.prefill_last = counted_prefill
    for r in requests:
        eng.submit(r)
    ticks, turned = [], False
    while eng.queue:
        live = sum(s is not None and not s.prefilling for s in eng.slots)
        written[0] = 0
        calls = decode_calls()
        sync()
        t = time.perf_counter()
        events = eng.step()
        sync()
        tick = dict(kind=eng.last_tick, s=time.perf_counter() - t,
                    tokens=len(events), steps=decode_calls() - calls,
                    written=written[0], live=live)
        if turned:
            ticks.append(tick)
        turned = turned or any(ev.finished for ev in events)
    eng.model.prefill_last = prefill_last
    if not ticks:
        raise RuntimeError("no request finished before the queue emptied: "
                           "give more requests")
    wall = sum(t["s"] for t in ticks)
    dec = [t for t in ticks if t["kind"] == "decode"]
    pre = [t for t in ticks if t["kind"] == "prefill"]
    n_steps = sum(t["steps"] for t in dec)
    # Thirds of the window's wall time: generated tokens/s in each.
    thirds, acc, cut = [[0.0, 0] for _ in range(3)], 0.0, wall / 3
    for t in ticks:
        i = min(int(acc // cut), 2)
        thirds[i][0] += t["s"]
        thirds[i][1] += t["tokens"]
        acc += t["s"]
    return dict(
        window_ticks=len(ticks), prefill_ticks=len(pre),
        decode_ticks=len(dec), window_s=wall,
        generated_tokens=sum(t["tokens"] for t in ticks),
        generated_tokens_per_s=sum(t["tokens"] for t in ticks) / wall,
        generated_tokens_per_s_by_third=[n / s if s else None
                                         for s, n in thirds],
        decode_steps=n_steps,
        decode_ms_per_step=1e3 * sum(t["s"] for t in dec) / max(n_steps, 1),
        prefill_tokens=sum(t["written"] for t in pre),
        prefill_tokens_per_s=(sum(t["written"] for t in pre)
                              / max(sum(t["s"] for t in pre), 1e-9)),
        live_row_share=(sum(t["live"] * t["steps"] for t in dec)
                        / max(eng.max_batch * n_steps, 1)),
        decode_share_of_wall=sum(t["s"] for t in dec) / wall)


def setup(cpu: bool):
    """(cfg, quest, prompt and new-token ranges, scheduler kwargs, device)
    of the run: full width on the card, a tiny model with ``cpu``."""
    from quest_tpu_torch.config import (ModelConfig, QuestConfig, RopeConfig,
                                        llama31_8b, serving_quest_config)
    if cpu:
        cfg = ModelConfig(vocab_size=256, hidden_size=64,
                          intermediate_size=128, num_layers=2, num_heads=4,
                          num_kv_heads=4, head_dim=16, rope=RopeConfig(),
                          dtype=torch.float32)
        quest = QuestConfig(page_size=8, token_budget=32, max_seq_len=256,
                            skip_layers=1, block_pages=4,
                            kv_dtype=torch.float32)
        return cfg, quest, ((40, 120), (8, 24)), dict(
            burst=4, prefill_chunk=32, prefill_bucket=16), "cpu"
    return (llama31_8b(), serving_quest_config(16384, kv_dtype=torch.bfloat16),
            ((2000, 6001), (128, 385)),
            dict(burst=8, prefill_chunk=2048, prefill_bucket=256), "cuda")


def run_load(params, n: int, device="cuda") -> Dict:
    """Warm up, then serve ``n`` requests over ``params`` (the setup's
    model on ``device``); the window's numbers (:func:`serve_window`)."""
    cfg, quest, ranges, kw, device = setup(torch.device(device).type == "cpu")
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    eng = ContinuousBatchingEngine(cfg, quest, params, max_batch=4,
                                   device=device, **kw)
    warm = make_requests(4, (ranges[0][0], ranges[0][0] + 1), (8, 9),
                         cfg.vocab_size, seed=1)
    eng.run([Request(1000 + r.uid, r.prompt, r.max_new_tokens)
             for r in warm])
    res = serve_window(eng, make_requests(n, *ranges, cfg.vocab_size), sync)
    res.update(requests=n, prompt_tokens=list(ranges[0]),
               new_tokens=list(ranges[1]), max_batch=eng.max_batch,
               page_size=quest.page_size, kv_dtype=str(quest.kv_dtype))
    return res


def main(argv=None) -> int:
    from quest_tpu_torch.engine.graphs import eager
    from quest_tpu_torch.models.llama import init_params
    args = list(sys.argv[1:] if argv is None else argv)
    cpu, eager_run = "--cpu" in args, "--eager" in args
    args = [a for a in args if a not in ("--cpu", "--eager")]
    n = int(args[0]) if args else 16
    cfg, _, _, _, device = setup(cpu)
    if cpu:
        gen = torch.Generator().manual_seed(0)
        card = "cpu (plain path; not a measurement)"
    else:
        if not torch.cuda.is_available():
            print("scheduler_load: no CUDA device; pass --cpu for the "
                  "plain path", file=sys.stderr)
            return 1
        gen = torch.Generator(device="cuda").manual_seed(0)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        from quest_tpu_torch.ops import _build
        _build.build(("prefill", "sparse_decode", "dense_decode"))
    print(card, flush=True)
    params = init_params(cfg, gen, device=device)
    with eager() if eager_run else contextlib.nullcontext():
        res = run_load(params, n, device)
    res.update(card=card, graphs=not eager_run)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
