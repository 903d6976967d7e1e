"""The whole decode step's share of the chip's peak: the least time the
steps' work needs, max(FLOPs / peak FLOP/s, bytes / peak bytes/s) a step
(bench/work.py:decode_step), over the decode ticks' host time."""

from bench.readers import decode_mfu


def read(rec):
    return decode_mfu(rec)
