"""Device milliseconds a decode step: from the mark before a step's
replay to the mark after it and its clone, over the decode ticks in the
window and outside the profiled sub-window (bench/program_trace.py)."""

from bench.program_trace import decode_step_device_ms


def read(rec):
    return decode_step_device_ms(rec)
