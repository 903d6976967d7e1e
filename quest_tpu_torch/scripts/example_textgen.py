"""Minimal generation example (counterpart of
``scripts/example_textgen.py``; the reference loads a model,
``quest_init(page_size=16, max_seq_len, token_budget)`` and calls
``model.generate()``).

    python -m quest_tpu_torch.scripts.example_textgen --model-path CKPT \\
        --prompt "..."
    python -m quest_tpu_torch.scripts.example_textgen --random \\
        --preset tiny --device cpu                              # smoke
"""

from __future__ import annotations

import argparse

from quest_tpu_torch.utils.cli import add_model_args, build_engine


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    ap.add_argument("--prompt", type=str,
                    default="Once upon a time, in a land far away, ")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0)
    return ap.parse_args(argv)


def run_example_textgen(engine, tok, args) -> dict:
    """Generates from ``args.prompt`` on ``engine``; prints the prompt
    with its continuation and returns the tokens and the text."""
    ids = tok.encode(args.prompt)
    out = engine.generate([ids], max_new_tokens=args.max_new_tokens,
                          temperature=args.temperature,
                          eos_token_id=getattr(tok, "eos_token_id", None))
    text = args.prompt + tok.decode(out[0])
    print(text)
    return {"prompt_tokens": len(ids), "tokens": out[0], "text": text}


def main(argv=None):
    args = parse_args(argv)
    engine, tok = build_engine(args)
    return run_example_textgen(engine, tok, args)


if __name__ == "__main__":
    main()
