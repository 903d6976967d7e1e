"""Inference engine — the generation loop (counterpart of
``quest_tpu/engine/engine.py``).

All per-step state (pool, metadata, seq_lens) lives on the device in a
``PagedKVCache`` that every step updates in place; ``clear()`` resets
the lengths and reuses the pool.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from quest_tpu_torch.config import ModelConfig, QuestConfig
from quest_tpu_torch.kv.paged_kv import init_cache
from quest_tpu_torch.models.llama import Params, QuestModel
from quest_tpu_torch.ops.utils import resolve_device, round_up


class QuestEngine:
    """Single-device engine: paged cache + prefill/decode steps.

    ``device`` defaults to ``"cuda"`` and raises when there is no card;
    pass ``device="cpu"`` for the plain PyTorch path. ``params`` are
    moved to the device; ``self.params`` keeps the tree as given, so a
    second engine (another budget) can share the weights.
    """

    def __init__(self, cfg: ModelConfig, quest: QuestConfig, params: Params,
                 batch_size: int = 1, prefill_bucket: int = 256,
                 prefill_chunk: int = 16384, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.quest = quest
        self.params = params
        self.batch_size = batch_size
        self.prefill_bucket = prefill_bucket
        # Long prompts prefill in chunks of at most this many tokens, so
        # the [B, T, hid] activations stay bounded.
        self.prefill_chunk = prefill_chunk
        self.model = QuestModel(cfg, quest, params).to(self.device)
        self.cache = init_cache(cfg, quest, batch_size, device=self.device)
        # Host mirror of seq_lens: overflow guards without device syncs.
        self._host_lens = np.zeros((batch_size,), np.int64)

    # -- lifecycle --------------------------------------------------------
    def clear(self) -> None:
        """Reset for a new conversation; the pool is reused."""
        self.cache.seq_lens.zero_()
        self._host_lens[:] = 0

    @property
    def seq_lens(self) -> np.ndarray:
        return self.cache.seq_lens.cpu().numpy()

    # -- steps -----------------------------------------------------------
    def prefill(self, prompts: Sequence[Sequence[int]]) -> np.ndarray:
        """Prefill (or continue) each sequence; returns last-token logits
        [B, V]. Prompts are padded to a multiple of ``prefill_bucket``;
        prompts longer than ``prefill_chunk`` run as several chunks."""
        B = self.batch_size
        assert len(prompts) == B
        remaining = [list(p) for p in prompts]
        out = np.zeros((B, self.cfg.vocab_size), np.float32)
        while any(remaining):
            chunk = [p[:self.prefill_chunk] for p in remaining]
            remaining = [p[self.prefill_chunk:] for p in remaining]
            lens = np.array([len(p) for p in chunk], np.int32)
            T = round_up(max(int(lens.max()), 1), self.prefill_bucket)
            if int(self._host_lens.max()) + T > self.quest.max_seq_len:
                raise ValueError(
                    f"prompt chunk of {T} (bucketed) tokens exceeds "
                    f"max_seq_len={self.quest.max_seq_len} at current "
                    f"fill {self._host_lens.max()}")
            toks = np.zeros((B, T), np.int32)
            for b, p in enumerate(chunk):
                toks[b, :len(p)] = np.asarray(p, np.int32)
            logits = self.model.prefill_last(
                self.cache, torch.from_numpy(toks).to(self.device),
                torch.from_numpy(lens).to(self.device))
            self._host_lens += lens
            # Keep each row's logits from the chunk holding ITS last real
            # token (rows that finished earlier ride later chunks with
            # lens=0, whose logits are garbage for them).
            got = logits[:, 0].cpu().numpy()
            out[lens > 0] = got[lens > 0]
        return out

    def _check_decode_room(self, n: int = 1) -> None:
        if int(self._host_lens.max()) + n > self.quest.max_seq_len:
            raise ValueError(
                f"decode past max_seq_len={self.quest.max_seq_len}: the "
                "append would clamp into the last page and corrupt it; "
                "raise QuestConfig.max_seq_len or clear() the engine")

    def decode(self, tokens: Sequence[int]) -> np.ndarray:
        """One decode step for the batch; returns logits [B, V]."""
        self._check_decode_room()
        tok = torch.as_tensor(np.asarray(tokens, np.int32), device=self.device)
        logits = self.model.decode_step(self.cache, tok)
        self._host_lens += 1
        return logits.cpu().numpy()

    # -- generation -------------------------------------------------------
    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int, temperature: float = 0.0,
                 eos_token_id: Optional[int] = None,
                 seed: int = 0) -> List[List[int]]:
        """Greedy (temperature=0) or sampled generation; sampling draws
        from a ``torch.Generator`` seeded with ``seed``."""
        B = self.batch_size
        logits = self.prefill(prompts)
        gen = torch.Generator().manual_seed(seed)
        out: List[List[int]] = [[] for _ in range(B)]
        done = np.zeros((B,), bool)
        next_tok = self._sample(logits, temperature, gen)
        for step in range(max_new_tokens):
            for b in range(B):
                if not done[b]:
                    out[b].append(int(next_tok[b]))
                    if eos_token_id is not None and next_tok[b] == eos_token_id:
                        done[b] = True
            if done.all() or step == max_new_tokens - 1:
                break
            logits = self.decode(next_tok)
            next_tok = self._sample(logits, temperature, gen)
        return out

    def generate_ondevice(self, prompts: Sequence[Sequence[int]],
                          max_new_tokens: int,
                          eos_token_id: Optional[int] = None
                          ) -> List[List[int]]:
        """Greedy generation with no per-step host sync: each step's
        argmax stays on the device and feeds the next step; the tokens
        are fetched once at the end and EOS is trimmed on the host."""
        logits = self.prefill(prompts)
        self._check_decode_room(max_new_tokens - 1)
        tok = torch.as_tensor(np.argmax(logits, axis=-1).astype(np.int32),
                              device=self.device)
        toks = [tok]
        for _ in range(max_new_tokens - 1):
            tok = self.model.decode_token_step(self.cache, tok)
            toks.append(tok)
        self._host_lens += max_new_tokens - 1
        out = torch.stack(toks, dim=1).cpu().numpy()        # [B, N]
        res: List[List[int]] = []
        for row in out:
            row = row.tolist()
            if eos_token_id is not None and eos_token_id in row:
                row = row[: row.index(eos_token_id) + 1]
            res.append(row)
        return res

    # -- on-device eval bursts -------------------------------------------
    # The eval harnesses run at serving speed through these: no per-token
    # host fetch; small results come back in bulk every ``sync_every``
    # steps, which also bounds how far the host runs ahead of the card.

    def feed_ondevice(self, tokens: np.ndarray,
                      sync_every: int = 512) -> None:
        """Advance the cache over known tokens [B, N] as decode steps (so
        sparsity applies, e.g. a question after a long context) without
        fetching any logits."""
        tokens = np.asarray(tokens, np.int32)
        B, N = tokens.shape
        assert B == self.batch_size
        self._check_decode_room(N)
        toks = torch.from_numpy(tokens).to(self.device)
        for t in range(N):
            logits = self.model.decode_step(self.cache, toks[:, t])
            if (t + 1) % sync_every == 0:
                logits[:, 0].cpu()          # throttle the launch queue
        self._host_lens += N

    def score_ondevice(self, tokens: np.ndarray, targets: np.ndarray,
                       sync_every: int = 256) -> np.ndarray:
        """Teacher-forced decode NLLs: feed ``tokens[:, t]``, score
        ``targets[:, t]`` (usually ``tokens`` shifted by one). Returns
        [B, N] f32, fetched one stacked chunk per ``sync_every`` steps."""
        tokens = np.asarray(tokens, np.int32)
        targets = np.asarray(targets, np.int32)
        B, N = tokens.shape
        assert targets.shape == (B, N) and B == self.batch_size
        self._check_decode_room(N)
        toks = torch.from_numpy(tokens).to(self.device)
        tgts = torch.from_numpy(targets).to(self.device)
        out = np.empty((B, N), np.float32)
        pend = []
        base = 0
        for t in range(N):
            pend.append(self.model.decode_nll_step(self.cache, toks[:, t],
                                                   tgts[:, t]))
            if len(pend) == sync_every or t == N - 1:
                out[:, base:base + len(pend)] = torch.stack(
                    pend, dim=1).cpu().numpy()
                base += len(pend)
                pend = []
        self._host_lens += N
        return out

    def greedy_ondevice(self, first_tokens: Sequence[int], n: int,
                        sync_every: int = 512) -> np.ndarray:
        """Feed ``first_tokens`` [B] and greedily generate ``n`` tokens on
        the device (argmax fed straight back); returns [B, n] int32.
        Unlike :meth:`generate_ondevice` this continues from the current
        cache state (e.g. right after a fed question)."""
        self._check_decode_room(n)
        tok = torch.as_tensor(np.asarray(first_tokens, np.int32),
                              device=self.device)
        chunks = []
        for start in range(0, n, sync_every):
            if chunks:
                tok.cpu()                   # throttle the launch queue
            chunks.append(self.model.decode_token_burst(
                self.cache, tok, min(sync_every, n - start)))
            tok = chunks[-1][:, -1]
        self._host_lens += n
        return torch.cat(chunks, dim=1).cpu().numpy()

    @staticmethod
    def _sample(logits: np.ndarray, temperature: float,
                gen: torch.Generator) -> np.ndarray:
        if temperature <= 0.0:
            return np.argmax(logits, axis=-1).astype(np.int32)
        probs = torch.softmax(torch.from_numpy(logits).double() / temperature,
                              dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].numpy().astype(
            np.int32)
