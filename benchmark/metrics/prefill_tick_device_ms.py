"""Device milliseconds a prefill tick: from the mark before its model
call to the mark after it, over the prefill ticks in the window and
outside the profiled sub-window (bench/program_trace.py)."""

from bench.program_trace import prefill_tick_device_ms


def read(rec):
    return prefill_tick_device_ms(rec)
