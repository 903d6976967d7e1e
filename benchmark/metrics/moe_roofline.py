"""The experts' kernels (router, gate/up and down products) against their
roofline, over the profiled sub-window (roofline/moe.py)."""

from bench.readers import roofline


def read(rec):
    return roofline(rec, "moe")
