"""Tokens served per second: every token event of the ticks that ended
inside the window, the tick running at its end included, over the
window's wall time, from its opening to that tick's end."""

from bench.readers import tokens_per_s


def read(rec):
    return tokens_per_s(rec)
