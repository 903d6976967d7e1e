"""The prefill ticks' share of the chip's peak: the model FLOPs of their
real tokens (linears, causal attention over each row's context, the
head of each row's last token) over peak FLOP/s times their host time."""

from bench.readers import prefill_mfu


def read(rec):
    return prefill_mfu(rec)
