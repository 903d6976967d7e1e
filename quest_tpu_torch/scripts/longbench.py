"""LongBench eval launcher (counterpart of ``scripts/longbench.py``).

The reference runs longchat-7b-v1.5-32k on 6 tasks at budgets 512-4096.
The dataset jsonl files must exist locally: one ``<task>.jsonl`` per
task inside ``--data-dir``, in the LongBench schema ({"input",
"context", "answers", "all_classes", ...}).

  python -m quest_tpu_torch.scripts.longbench --model-path CKPT_DIR \\
      --data-dir data/longbench --tasks narrativeqa,hotpotqa \\
      --token-budget 2048 --out-dir results/longbench
  python -m quest_tpu_torch.scripts.longbench --random --preset tiny \\
      --device cpu --data-dir DIR --tasks hotpotqa --max-prompt-len 512
"""

from __future__ import annotations

import argparse
import json
import os

from quest_tpu_torch.utils.cli import add_model_args, build_engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--data-dir", type=str, required=True)
    ap.add_argument("--tasks", type=str,
                    default="narrativeqa,qasper,hotpotqa,triviaqa,"
                            "musique,gov_report")
    ap.add_argument("--max-prompt-len", type=int, default=31500)
    ap.add_argument("--out-dir", type=str, default=None)
    args = ap.parse_args(argv)

    from quest_tpu_torch.evals.longbench import evaluate_longbench

    engine, tok = build_engine(args)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    results = evaluate_longbench(engine, tok, args.data_dir,
                                 args.tasks.split(","),
                                 args.max_prompt_len, args.out_dir)
    print(json.dumps(results, indent=2))
    if args.out_dir:
        with open(os.path.join(args.out_dir, "result.json"), "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
