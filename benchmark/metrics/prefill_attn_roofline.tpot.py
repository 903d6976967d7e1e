"""The prefill attention kernel against its roofline over the profiled
sub-window: the causal attention of the real question tokens over their
context (roofline/prefill_attn.py)."""

from bench.readers import roofline


def read(rec):
    return roofline(rec, "prefill_attn")
