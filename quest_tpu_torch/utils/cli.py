"""Shared command-line plumbing of the eval launchers (counterpart of
``quest_tpu/utils/cli.py``).

Two model sources:
  * ``--model-path DIR``: a local HF Llama/Mistral checkpoint, converted
    by ``models/loader.py``, with its tokenizer (``transformers``,
    imported only for this);
  * ``--random``: random weights on a named preset's geometry (smoke and
    latency runs: the accuracy numbers mean nothing) with the byte-level
    :class:`ByteTokenizer`, which needs no files.

``--device`` (default ``cuda``) places the engine; ``--device cpu`` runs
the plain PyTorch path. ``--quantize 8`` or ``4`` quantizes the weights
(RTN, ``models/quantize.py``) before the engine is built.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Tuple

import torch

from quest_tpu_torch.config import (QuestConfig, llama31_8b,
                                    longchat_7b_v15_32k, mistral_7b_v03,
                                    small_tpu_model, tiny_test_model,
                                    yarn_llama2_7b_128k)

PRESETS = {
    "llama31-8b": llama31_8b,
    "longchat-7b": longchat_7b_v15_32k,
    "mistral-7b": mistral_7b_v03,
    "yarn-llama2-7b": yarn_llama2_7b_128k,
    "tiny": tiny_test_model,
    "small-tpu": small_tpu_model,
}


class ByteTokenizer:
    """Byte-level fallback tokenizer (ids = bytes + 3 specials)."""

    bos_token_id = 1
    eos_token_id = 2
    pad_token_id = 0

    def __call__(self, text, return_tensors=None, **kw):
        ids = self.encode(text)
        if return_tensors == "np":
            import numpy as np
            return type("E", (), {"input_ids": np.asarray([ids])})()
        return type("E", (), {"input_ids": [ids]})()

    def encode(self, text: str, add_special_tokens: bool = True):
        ids = [b + 3 for b in text.encode("utf-8", errors="replace")]
        return ([self.bos_token_id] + ids) if add_special_tokens else ids

    def decode(self, ids, skip_special_tokens: bool = True):
        return bytes(max(0, min(255, i - 3)) for i in ids
                     if i > 2 or not skip_special_tokens).decode(
                         "utf-8", errors="replace")


def add_model_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--model-path", type=str, default=None,
                    help="local HF checkpoint dir")
    ap.add_argument("--random", action="store_true",
                    help="random weights on --preset geometry")
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--layers", type=int, default=None,
                    help="override layer count (fit one card)")
    ap.add_argument("--token-budget", type=int, default=2048)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-seq-len", type=int, default=None)
    ap.add_argument("--skip-layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engine runs (cpu: the plain PyTorch "
                         "path)")
    ap.add_argument("--quantize", type=int, default=0, choices=[0, 4, 8],
                    help="weight-only quantization bits (0 = off)")


def build_engine(args, params=None) -> Tuple["QuestEngine", object]:
    """Returns (engine, tokenizer). ``params``, with ``--random``, are
    weights already made for the preset's geometry (at ``--layers``), used
    in place of a new random draw."""
    from quest_tpu_torch.engine.engine import QuestEngine
    from quest_tpu_torch.models.llama import init_params
    from quest_tpu_torch.ops.utils import resolve_device

    device = resolve_device(args.device)
    if args.model_path:
        import transformers

        from quest_tpu_torch.models.loader import load_hf_model
        cfg, params = load_hf_model(args.model_path, device=device)
        tok = transformers.AutoTokenizer.from_pretrained(args.model_path)
    elif args.random:
        cfg = PRESETS[args.preset]()
        if args.preset == "tiny":
            cfg = dataclasses.replace(cfg, vocab_size=259)
        tok = ByteTokenizer()
    else:
        raise SystemExit("pass --model-path DIR or --random")

    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    max_seq = args.max_seq_len or min(cfg.max_position_embeddings, 32768)
    quest = QuestConfig(page_size=args.page_size,
                        token_budget=args.token_budget,
                        max_seq_len=max_seq,
                        skip_layers=args.skip_layers)
    if params is None:
        params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                             device=device)
    if args.quantize:
        from quest_tpu_torch.models.quantize import quantize_params
        params = quantize_params(params, args.quantize)
    engine = QuestEngine(cfg, quest, params, batch_size=args.batch,
                         device=device)
    return engine, tok
