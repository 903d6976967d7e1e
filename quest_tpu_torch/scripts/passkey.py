"""Passkey retrieval eval launcher (counterpart of
``scripts/passkey.py``).

The reference runs Llama-3.1-8B and Mistral-7B at ~100k-character
contexts, budgets 512-4096, 100 iterations across depth ratios.

  python -m quest_tpu_torch.scripts.passkey --model-path CKPT_DIR \\
      --n-garbage 60000 --iterations 100 --token-budget 1024
  python -m quest_tpu_torch.scripts.passkey --random --preset tiny \\
      --device cpu --n-garbage 2000 --iterations 2            # smoke
"""

from __future__ import annotations

import argparse
import json

from quest_tpu_torch.utils.cli import add_model_args, build_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--n-garbage", type=int, default=60000,
                    help="filler chars (the reference uses ~60k = 10k "
                         "tokens)")
    ap.add_argument("--iterations", type=int, default=20)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--output", type=str, default=None)
    args = ap.parse_args(argv)

    from quest_tpu_torch.evals.passkey import evaluate_passkey

    engine, tok = build_engine(args)
    res = evaluate_passkey(engine, tok, n_garbage=args.n_garbage,
                           iterations=args.iterations,
                           max_new_tokens=args.max_new_tokens)
    print(f"passkey accuracy (budget {engine.quest.token_budget}): "
          f"{res.accuracy:.3f} ({res.correct}/{res.total})")
    for d, acc in sorted(res.per_depth.items()):
        print(f"  depth {d:.1f}: {acc:.2f}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"accuracy": res.accuracy, "correct": res.correct,
                       "total": res.total,
                       "per_depth": {str(k): v for k, v
                                     in res.per_depth.items()}}, f)
    return res


if __name__ == "__main__":
    main()
