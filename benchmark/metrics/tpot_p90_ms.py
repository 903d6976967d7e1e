"""The 90th percentile (nearest rank) of the time per output token over
every request due in the window: (last token - first) / (tokens - 1);
a request never finished counts the time from its due time to the
drain's end."""

from bench.readers import percentile, tpot_s


def read(rec):
    p = percentile(tpot_s(rec), 90)
    return None if p is None else 1e3 * p
