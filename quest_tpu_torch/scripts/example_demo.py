"""Side-by-side demo: Quest sparse decode against full-cache decode
(counterpart of ``scripts/example_demo.py``; the reference's TUI compares
``quest_init(token_budget=2048)`` with a full-cache run).

The same prompt is generated twice, with the engine's budget and with
budget = ``max_seq_len`` (the dense control, over the same weights),
printing each continuation, its decode ms a token, the token agreement
and the decode ratio.

    python -m quest_tpu_torch.scripts.example_demo --model-path CKPT \\
        --token-budget 2048 --prompt-file long_context.txt
    python -m quest_tpu_torch.scripts.example_demo --random --preset tiny \\
        --device cpu                                            # smoke
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from quest_tpu_torch.utils.cli import add_model_args, build_engine


def run_once(engine, prompt_ids, max_new):
    """Greedy generation with a host fetch a step (as the demo shows
    tokens); returns (tokens, prefill s, decode s a token)."""
    engine.clear()
    t0 = time.perf_counter()
    logits = engine.prefill([prompt_ids])
    t_prefill = time.perf_counter() - t0
    out = []
    nxt = int(np.argmax(logits[0]))
    t0 = time.perf_counter()
    for _ in range(max_new):
        out.append(nxt)
        logits = engine.decode([nxt])
        nxt = int(np.argmax(logits[0]))
    t_decode = (time.perf_counter() - t0) / max_new
    return out, t_prefill, t_decode


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--prompt", type=str,
                    default="Tell me the story of the three kingdoms. ")
    ap.add_argument("--prompt-file", type=str, default=None)
    ap.add_argument("--max-new-tokens", type=int, default=32)
    return ap.parse_args(argv)


def run_example_demo(engine, tok, args) -> dict:
    """The demo over ``engine`` (the Quest budget) and a full-cache engine
    on the same weights and device; returns both runs' tokens and
    times."""
    from quest_tpu_torch.engine.engine import QuestEngine

    if args.prompt_file:
        with open(args.prompt_file) as f:
            text = f.read()
    else:
        text = args.prompt
    ids = tok.encode(text)
    quest_out, tp1, td1 = run_once(engine, ids, args.max_new_tokens)

    # Full-cache control: budget = max_seq_len, the same weights.
    full_quest = dataclasses.replace(engine.quest,
                                     token_budget=engine.quest.max_seq_len)
    full = QuestEngine(engine.cfg, full_quest, engine.params, batch_size=1,
                       prefill_bucket=engine.prefill_bucket,
                       device=engine.device)
    full_out, tp2, td2 = run_once(full, ids, args.max_new_tokens)
    del full

    print(f"=== Quest (budget {engine.quest.token_budget}) "
          f"— decode {td1 * 1e3:.2f} ms/tok ===")
    print(tok.decode(quest_out))
    print(f"=== Full cache (budget {full_quest.token_budget}) "
          f"— decode {td2 * 1e3:.2f} ms/tok ===")
    print(tok.decode(full_out))
    same = sum(a == b for a, b in zip(quest_out, full_out))
    print(f"token agreement: {same}/{len(quest_out)}; "
          f"decode speedup {td2 / max(td1, 1e-9):.2f}x")
    return {"prompt_tokens": len(ids), "quest_tokens": quest_out,
            "full_tokens": full_out, "agreement": same,
            "quest_prefill_s": tp1, "full_prefill_s": tp2,
            "quest_decode_ms": td1 * 1e3, "full_decode_ms": td2 * 1e3}


def main(argv=None):
    args = parse_args(argv)
    engine, tok = build_engine(args)
    return run_example_demo(engine, tok, args)


if __name__ == "__main__":
    main()
