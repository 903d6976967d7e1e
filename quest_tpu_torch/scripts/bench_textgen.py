"""End-to-end text-generation latency benchmark (counterpart of
``scripts/bench_textgen.py``).

Prefill a random context once, then decode N tokens greedily on the
device and report the per-token latency; ``--ab-full`` also times the
full-cache control in the same process over the same weights and
reports the end-to-end decode ratio (the reference's ``budget=102400``
control row, ``bench_efficiency_e2e.sh``). Weights are random (latency
is shape-determined); ``--layers`` cuts the depth (0 = the preset's).

The decode loop stays on the device: ``decode_token_step`` (or
``decode_token_burst`` with ``--burst n``) feeds each argmax straight
back, and the timed window is closed by ``torch.cuda.synchronize()``.
With ``--device cpu`` the context is clamped to 1024 tokens.

    python -m quest_tpu_torch.scripts.bench_textgen --layers 32 \\
        --ctx 32768 --budget 2048 --ab-full
    python -m quest_tpu_torch.scripts.bench_textgen --model tiny \\
        --layers 2 --device cpu --decode-tokens 8              # smoke
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llama31-8b",
                    choices=["llama31-8b", "longchat-7b", "mistral-7b",
                             "tiny"])
    ap.add_argument("--layers", type=int, default=8,
                    help="override the layer count (0 = the preset's)")
    ap.add_argument("--ctx", type=int, default=32768)
    ap.add_argument("--budget", default="2048",
                    help="token budget, or 'full' for the dense control")
    ap.add_argument("--page", type=int, default=16)
    ap.add_argument("--decode-tokens", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--skip-layers", type=int, default=2)
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "fp8"],
                    help="KV-cache storage dtype (fp8 = e4m3)")
    ap.add_argument("--quantize", type=int, default=0, choices=[0, 4, 8],
                    help="weight-only quantization bits (RTN)")
    ap.add_argument("--topk", default="exact",
                    choices=["exact", "exact_fast", "approx"],
                    help="QuestConfig.topk_method (the port runs each as "
                         "exact top-k)")
    ap.add_argument("--meta-dtype", default="kv", choices=["kv", "fp8"],
                    help="min/max-Key metadata dtype")
    ap.add_argument("--fused", action="store_true",
                    help="decode through the fused kernel")
    ap.add_argument("--burst", type=int, default=1,
                    help="decode steps a call (decode_token_burst)")
    ap.add_argument("--prefill-chunk", type=int, default=8192,
                    help="max prompt tokens a prefill call")
    ap.add_argument("--ab-full", action="store_true",
                    help="also time the full-cache control (every layer "
                         "dense) in the same process over the same weights")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def model_config(args):
    from quest_tpu_torch.config import (llama31_8b, longchat_7b_v15_32k,
                                        mistral_7b_v03, tiny_test_model)
    presets = {"llama31-8b": llama31_8b, "longchat-7b": longchat_7b_v15_32k,
               "mistral-7b": mistral_7b_v03, "tiny": tiny_test_model}
    cfg = presets[args.model]()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def make_params(cfg, args):
    """Random weights on the device, from seed 0; quantized tensor by
    tensor at creation with ``--quantize`` (no bf16 copy of the model)."""
    from quest_tpu_torch.ops.utils import resolve_device
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.quantize:
        from quest_tpu_torch.models.quantize import init_params_quantized
        return init_params_quantized(cfg, gen, args.quantize, device=dev)
    from quest_tpu_torch.models.llama import init_params
    return init_params(cfg, gen, device=dev)


def run_bench_textgen(cfg, params, args) -> dict:
    """Prefill + timed decode of ``cfg`` over ``params`` (on
    ``args.device``) with the options of :func:`parse_args`; returns the
    JSON dict."""
    from quest_tpu_torch.config import QuestConfig
    from quest_tpu_torch.engine.engine import QuestEngine
    from quest_tpu_torch.ops.utils import resolve_device

    dev = resolve_device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    ctx = args.ctx if dev.type == "cuda" else min(args.ctx, 1024)
    budget = ctx if args.budget == "full" else int(args.budget)
    f8 = torch.float8_e4m3fn
    # Room for ctx + the warm-up and timed decode runs (2N tokens).
    quest = QuestConfig(page_size=args.page, token_budget=budget,
                        max_seq_len=(ctx + 2 * args.decode_tokens
                                     + 2 + args.page),
                        skip_layers=args.skip_layers,
                        kv_dtype=f8 if args.kv_dtype == "fp8"
                        else torch.bfloat16,
                        meta_dtype=f8 if args.meta_dtype == "fp8" else None,
                        topk_method=args.topk, fused_decode=args.fused)
    log(f"model={args.model} L={cfg.num_layers} Hq={cfg.num_heads} "
        f"Hkv={cfg.num_kv_heads} ctx={ctx} budget={budget} device={dev}")

    def make_engine(q):
        return QuestEngine(cfg, q, params, batch_size=args.batch,
                           prefill_bucket=min(ctx, 2048),
                           prefill_chunk=args.prefill_chunk, device=dev)

    engine = make_engine(quest)
    rng = np.random.default_rng(0)
    prompt = [p.tolist() for p in rng.integers(
        1, cfg.vocab_size, size=(args.batch, ctx)).astype(np.int32)]

    # Prefill, timed after one warm-up (which builds the kernels).
    engine.prefill(prompt)
    engine.clear()
    sync()
    t0 = time.perf_counter()
    logits = engine.prefill(prompt)
    t_prefill = time.perf_counter() - t0

    nb = max(1, args.burst)
    N = -(-args.decode_tokens // nb) * nb

    def loop(eng, tok, steps):
        for _ in range(steps // nb):
            if nb == 1:
                tok = eng.model.decode_token_step(eng.cache, tok)
            else:
                tok = eng.model.decode_token_burst(eng.cache, tok, nb)[:, -1]
        return tok

    def timed_decode(eng, tok):
        tok = loop(eng, tok, nb)            # warm-up: one burst
        sync()
        t = time.perf_counter()
        tok = loop(eng, tok, N)
        sync()
        dt = (time.perf_counter() - t) / N
        assert bool(((tok >= 0) & (tok < cfg.vocab_size)).all()), "bad token"
        return dt

    tok = torch.as_tensor(np.argmax(logits, axis=-1).astype(np.int32),
                          device=dev)
    t_decode = timed_decode(engine, tok)
    toks_per_s = args.batch / t_decode
    log(f"prefill {ctx} tokens: {t_prefill * 1e3:.1f} ms "
        f"({ctx / t_prefill:.0f} tok/s)")
    log(f"decode: {t_decode * 1e3:.3f} ms/token ({toks_per_s:.1f} tok/s)")
    result = {
        "model": args.model, "layers": cfg.num_layers, "ctx": ctx,
        "budget": budget, "batch": args.batch,
        "quantize_bits": args.quantize, "kv_dtype": args.kv_dtype,
        "meta_dtype": args.meta_dtype, "topk": args.topk,
        "fused": bool(args.fused),
        "prefill_ms": round(t_prefill * 1e3, 1),
        "decode_ms_per_token": round(t_decode * 1e3, 3),
        "decode_tokens_per_s": round(toks_per_s, 1),
    }

    if args.ab_full and budget < ctx:
        # The full-cache control takes the reference's dense fallback:
        # skip_layers = L sends every layer through dense decode, with no
        # estimate and no top-k (running budget = ctx through the
        # selection stack would be slower than the dense path and inflate
        # the ratio). Weights are shared; the first pool is dropped first.
        del engine
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        engine = make_engine(dataclasses.replace(
            quest, token_budget=ctx, skip_layers=cfg.num_layers))
        engine.prefill(prompt)
        tok = torch.full((args.batch,), 7, dtype=torch.int32, device=dev)
        t_full = timed_decode(engine, tok)     # the same burst depth
        result["full_cache_ms_per_token"] = round(t_full * 1e3, 3)
        result["e2e_decode_speedup"] = round(t_full / t_decode, 2)
        log(f"full-cache control: {t_full * 1e3:.3f} ms/token -> "
            f"e2e speedup {t_full / t_decode:.2f}x")
    return result


def main(argv=None):
    args = parse_args(argv)
    cfg = model_config(args)
    out = run_bench_textgen(cfg, make_params(cfg, args), args)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
