"""Share of the profiled sub-window in which no device op ran (the union
of every kernel, copy and set interval in the trace)."""

from bench.readers import idle_share


def read(rec):
    return idle_share(rec)
