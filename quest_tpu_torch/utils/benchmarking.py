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
    between launches, as a decode step finds each layer's pages cold."""

    def __init__(self):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        torch.cuda._sleep(100_000_000)   # ~50 ms: the host queues ahead
        for start, end in events:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)
