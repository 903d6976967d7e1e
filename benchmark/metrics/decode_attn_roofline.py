"""Quest's decode attention kernels (estimate, top-k, sparse and dense
decode) against their roofline, over the profiled sub-window
(roofline/decode_attn.py)."""

from bench.readers import roofline


def read(rec):
    return roofline(rec, "decode_attn")
