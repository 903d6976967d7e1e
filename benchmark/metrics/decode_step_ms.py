"""Host milliseconds a decode step: the decode ticks' host time (each
ends in the scheduler's own host fetch) over their steps, in the window
and outside the profiled sub-window."""

from bench.readers import decode_step_ms


def read(rec):
    return decode_step_ms(rec)
