"""Device timing on the card (counterpart of
``quest_tpu/utils/benchmarking.py``).

The JAX package timed ops by the slope of a device-side loop at two trip
counts, because its remote TPU could not be timed from the host; on a
local CUDA card :class:`Timer` takes CUDA events around each launch
instead.
"""

from __future__ import annotations

import statistics

import torch


class Timer:
    """Median of per-launch CUDA-event times of the device work of
    ``fn``. All launches are queued behind a sleep kernel, so the host's
    enqueue time does not enter the events; the 50 MB L2 is flushed
    between launches, as a decode step finds each layer's pages cold.
    ``flush="memset"`` (the default, every PR's tables) writes 256 MB,
    which leaves the L2 full of dirty lines that the timed kernel's
    misses write back (up to 50 MB of extra traffic); ``flush="read"``
    reads 256 MB instead, which leaves clean lines."""

    def __init__(self, flush="memset"):
        if flush not in ("memset", "read"):
            raise ValueError(f"flush={flush!r}; expected 'memset' or 'read'")
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
        if flush == "read":
            self.flush.zero_()
        self.kind = flush

    def __call__(self, fn, iters=20, warmup=3, flush=True):
        """Median ms of ``fn``'s device work; ``flush=False`` keeps the L2
        as the previous launch left it (a consumer right after its
        producer)."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        torch.cuda._sleep(100_000_000)   # ~50 ms: the host queues ahead
        for start, end in events:
            if flush and self.kind == "memset":
                self.flush.zero_()
            elif flush:
                self.flush.view(torch.int32).sum()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def in_turns(timer, fns):
    """Each of ``fns`` (name: callable) timed by ``timer`` twice, in turns
    (each in order, then in reverse), so that two versions compared meet
    the card in the same states; returns {name: [ms, ms]}."""
    names = list(fns) + list(fns)[::-1]
    out = {}
    for n in names:
        out.setdefault(n, []).append(timer(fns[n]))
    return out
