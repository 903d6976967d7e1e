"""Sparse-vs-dense accuracy delta, end to end on the same engine
(counterpart of ``scripts/accuracy_delta.py``).

Runs the engine at a sweep of token budgets against the full-cache
control (budget >= context) and reports, per budget:

  * teacher-forced NLL / perplexity deltas (the PG19 protocol: every
    prediction after the prefilled context is a decode step with the
    sparsity live; ``QuestEngine.score_ondevice``), and
  * greedy-generation agreement with the control (``greedy_ondevice``):
    the share of equal tokens and the first divergent step.

With ``--random`` weights the absolute perplexity means nothing and
attention is more diffuse than a trained model's, so the deltas bound
the selection's error under stress; with ``--model-path`` they are the
PG19-protocol numbers. The token stream mixes noise with repeated
motifs, so pages are not statistically exchangeable.

    python -m quest_tpu_torch.scripts.accuracy_delta --random \\
        --preset llama31-8b --ctx 4096 --eval-tokens 256 \\
        --budgets 256,512,1024
    python -m quest_tpu_torch.scripts.accuracy_delta --random --preset tiny \\
        --device cpu --ctx 512 --eval-tokens 48 --budgets 64,128   # smoke
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from quest_tpu_torch.utils.cli import add_model_args, build_engine


def make_stream(vocab: int, n: int, seed: int) -> list:
    """Noise interleaved with repeated motifs (non-exchangeable pages)."""
    rng = np.random.default_rng(seed)
    motifs = [rng.integers(3, vocab, size=int(rng.integers(12, 40)))
              for _ in range(6)]
    out: list = []
    while len(out) < n:
        if rng.random() < 0.5:
            out.extend(rng.integers(3, vocab,
                                    size=int(rng.integers(20, 60))).tolist())
        else:
            out.extend(motifs[int(rng.integers(0, len(motifs)))].tolist())
    return out[:n]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--ctx", type=int, default=4096)
    ap.add_argument("--eval-tokens", type=int, default=256)
    ap.add_argument("--gen-tokens", type=int, default=64)
    ap.add_argument("--budgets", type=str, default="512,1024,2048")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json-out", type=str, default=None)
    return ap.parse_args(argv)


def _refuse_dense_only(skip_layers: int, num_layers: int) -> None:
    # A run whose every layer is dense matches the control at every
    # budget (delta 0): the study would be vacuous.
    if skip_layers >= num_layers:
        raise SystemExit(
            f"skip_layers={skip_layers} >= num_layers={num_layers}: no "
            "layer runs sparse; pass --skip-layers < layers")


def run_accuracy_delta(args, build=None) -> dict:
    """The budget sweep of ``args`` (see :func:`parse_args`). ``build(args)
    -> (engine, tokenizer)`` makes the engine of ``args.token_budget``
    (default: ``utils/cli.py:build_engine``). Returns the JSON dict."""
    build = build or build_engine
    budgets = [int(b) for b in args.budgets.split(",")]
    if args.layers:
        _refuse_dense_only(args.skip_layers, args.layers)
    args.max_seq_len = max(args.max_seq_len or 0,
                           args.ctx + args.gen_tokens + 64)
    # Full-cache control: a budget that covers every page of the context.
    full_budget = args.max_seq_len
    if full_budget not in budgets:
        budgets = budgets + [full_budget]

    rows = []
    base_nll = base_gen = None
    ids = None
    for budget in sorted(budgets, reverse=True):      # the control first
        args.token_budget = budget
        engine, _ = build(args)
        _refuse_dense_only(engine.quest.skip_layers, engine.cfg.num_layers)
        if ids is None:
            ids = make_stream(engine.cfg.vocab_size,
                              args.ctx + args.eval_tokens, seed=args.seed)
        warm = args.ctx
        engine.clear()
        logits = engine.prefill([ids[:warm]])
        feed = np.asarray([ids[warm:-1]], np.int32)
        tgts = np.asarray([ids[warm + 1:]], np.int32)
        x = logits[0] - logits[0].max()
        first = float(np.log(np.exp(x).sum()) - x[ids[warm]])
        nll = np.concatenate([[first],
                              engine.score_ondevice(feed, tgts)[0]])
        # Greedy continuation from the same prefix (fresh state).
        engine.clear()
        engine.prefill([ids[:warm]])
        gen = engine.greedy_ondevice([ids[warm]],
                                     args.gen_tokens)[0].tolist()
        del engine
        ppl = float(np.exp(nll.mean()))
        if budget >= full_budget:
            base_nll, base_gen = nll, gen
        agree = np.mean([a == b for a, b in zip(gen, base_gen)])
        div = next((i for i, (a, b) in enumerate(zip(gen, base_gen))
                    if a != b), len(gen))
        rows.append({
            "budget": budget, "ppl": round(ppl, 5),
            "delta_ppl": round(ppl - float(np.exp(base_nll.mean())), 5),
            "mean_abs_delta_nll": round(
                float(np.abs(nll - base_nll).mean()), 6),
            "gen_agree": round(float(agree), 4),
            "first_divergence": int(div),
        })
        print(f"budget {budget:>7}: ppl {ppl:.4f}  "
              f"delta_ppl {rows[-1]['delta_ppl']:+.5f}  "
              f"gen_agree {rows[-1]['gen_agree']:.3f}  "
              f"first_div {div}", flush=True)

    out = {"ctx": args.ctx, "eval_tokens": args.eval_tokens,
           "preset": args.preset, "random_weights": bool(args.random),
           "rows": rows}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


def main(argv=None):
    out = run_accuracy_delta(parse_args(argv))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
