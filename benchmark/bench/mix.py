"""What a traffic generator returns: the documents, the requests served
in set-up, and the requests of the measured window, as a closed loop
(each client's requests in order, the next sent when the last is
answered) or an open loop (requests due at fixed times)."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Req:
    """A request: the prompt is document ``doc`` (None: no shared prefix)
    followed by ``tail``; greedy, ``max_new`` tokens, no end token."""

    doc: Optional[int]
    tail: np.ndarray
    max_new: int


@dataclasses.dataclass
class Traffic:
    docs: List[np.ndarray]
    setup: List[Req]          # served in set-up: publishes the documents
    warm: List[Req]           # served in set-up: every shape of the window
    clients: Optional[List[List[Req]]] = None      # closed loop
    arrivals: Optional[List[Tuple[float, Req]]] = None  # open loop
    engine: Dict = dataclasses.field(default_factory=dict)
    check: Dict = dataclasses.field(default_factory=dict)
    drain_s: float = 60.0
    trace_ticks: int = 12


def block_permutation(n: int, block: int, rng: np.random.Generator):
    """A permutation of range(n) that reorders within consecutive blocks
    of ``block``: every seed gets the same items in each block, in
    another order."""
    idx = np.arange(n)
    for b0 in range(0, n, block):
        idx[b0:b0 + block] = b0 + rng.permutation(min(block, n - b0))
    return idx


def lengths(rng: np.random.Generator, lo: int, hi: int, n: int,
            dist: str) -> np.ndarray:
    """``n`` lengths in [lo, hi]: ``uniform`` integers, or ``log_uniform``
    (the log of the length uniform)."""
    if dist == "uniform":
        return rng.integers(lo, hi + 1, size=n)
    if dist == "log_uniform":
        x = np.exp(rng.uniform(math.log(lo), math.log(hi + 1), size=n))
        return np.clip(np.floor(x).astype(np.int64), lo, hi)
    raise ValueError(f"unknown length distribution {dist!r}")


def tokens(rng: np.random.Generator, vocab: int, n: int) -> np.ndarray:
    """``n`` token ids in [1, vocab)."""
    return rng.integers(1, vocab, size=int(n), dtype=np.int64)
