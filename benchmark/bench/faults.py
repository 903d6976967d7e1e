"""Faults planted under the timed path, for the proof that the check
catches them: the CPU tests plant each in a whole run at a tiny size,
and ``calibrate.py --fault <name>`` plants one on the card at a cell's
own size. Each is a patch of the port's module or class, made while the
engine is built (so the captured decode step holds it) and undone at
the end. No run of the benchmark plants one.

- ``state_unchanged``: the decode step's append writes nothing; the
  cache keeps its state and only the rotated query comes back;
- ``half_batch``: the second half of the batch's logits replaced by the
  mean of the first half's;
- ``token_altered``: the first row's token changed where it is produced;
- ``select_first``: Quest's selection takes the first pages under the
  budget (and the current page) in place of the top-scored ones.
"""

from __future__ import annotations

import contextlib

import torch


def _stale_cache(cache, layer, q, k, v, cos, sin, active=None):
    from quest_tpu_torch.ops.rope import rotate_plain
    B = q.shape[0]
    cs, sn = (t.reshape(B, 1, t.shape[-1]) for t in (cos, sin))
    return rotate_plain(q, cs, sn)


def _half_batch(orig):
    def decode_step(self, cache, tokens, active=None):
        logits = orig(self, cache, tokens, active)
        half = logits.shape[0] // 2
        return torch.cat([logits[:half],
                          logits[:half].mean(0, keepdim=True).expand(
                              logits.shape[0] - half, -1)])
    return decode_step


def _altered_token(orig):
    def decode_token_step(self, cache, tokens, active=None):
        out = orig(self, cache, tokens, active).clone()
        out[0] = (out[0] + 1) % self.cfg.vocab_size
        return out
    return decode_token_step


def _first_pages(orig):
    def select_pages(scores, seq_lens, page_size, budget_pages):
        P = scores.shape[-1]
        first = torch.zeros_like(scores) - torch.arange(
            P, device=scores.device, dtype=scores.dtype)
        return orig(first, seq_lens, page_size, budget_pages)
    return select_pages


def _patches(name: str):
    from quest_tpu_torch.models import llama
    M = llama.QuestModel
    if name == "state_unchanged":
        return [(llama, "rope_append_decode_at", _stale_cache)]
    if name == "half_batch":
        return [(M, "decode_step", _half_batch(M.decode_step))]
    if name == "token_altered":
        return [(M, "decode_token_step", _altered_token(M.decode_token_step))]
    if name == "select_first":
        return [(llama, "select_pages", _first_pages(llama.select_pages))]
    raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")


FAULTS = ("state_unchanged", "half_batch", "token_altered", "select_first")


@contextlib.contextmanager
def planted(name: str):
    """The port with fault ``name`` planted while the block runs."""
    patches = _patches(name)
    saved = [(obj, attr, obj.__dict__[attr]) for obj, attr, _ in patches]
    try:
        for obj, attr, new in patches:
            setattr(obj, attr, new)
        yield
    finally:
        for obj, attr, old in saved:
            setattr(obj, attr, old)
