"""PG19-protocol perplexity eval launcher (counterpart of
``scripts/ppl_eval.py``).

Token-by-token NLL over a text (the reference runs the first PG19 test
book with longchat-7b-v1.5-32k, token budget 4096, 30k eval tokens);
writes ``log.txt`` and ``ppl.txt`` to ``--output-dir``. The text comes
from ``--text-file`` (e.g. a local PG19 book); without one a short
built-in text is used.

  python -m quest_tpu_torch.scripts.ppl_eval --model-path CKPT_DIR \\
      --text-file pg19_book0.txt --num-eval-tokens 30000 \\
      --token-budget 4096 --output-dir results/ppl
  python -m quest_tpu_torch.scripts.ppl_eval --random --preset tiny \\
      --device cpu --num-eval-tokens 64                       # smoke
"""

from __future__ import annotations

import argparse
import os

from quest_tpu_torch.utils.cli import add_model_args, build_engine

_SMOKE_TEXT = ("The quick brown fox jumps over the lazy dog. " * 40)


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--text-file", type=str, default=None)
    ap.add_argument("--num-eval-tokens", type=int, default=30000)
    ap.add_argument("--output-dir", type=str, default=None)
    args = ap.parse_args(argv)

    from quest_tpu_torch.evals.perplexity import evaluate_perplexity

    engine, tok = build_engine(args)
    if args.text_file:
        with open(args.text_file) as f:
            text = f.read()
    else:
        text = _SMOKE_TEXT
    ids = tok.encode(text)
    n = min(args.num_eval_tokens, len(ids) - 2,
            engine.quest.max_seq_len - 2)

    log_path = None
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        log_path = os.path.join(args.output_dir, "log.txt")
    ppl = evaluate_perplexity(engine, ids, num_eval_tokens=n,
                              log_path=log_path)
    print(f"perplexity over {n} tokens (budget "
          f"{engine.quest.token_budget}): {ppl:.4f}")
    if args.output_dir:
        with open(os.path.join(args.output_dir, "ppl.txt"), "w") as f:
            print(ppl, file=f)
    return ppl


if __name__ == "__main__":
    main()
