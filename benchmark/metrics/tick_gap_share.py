"""Share of the device's time, on its own clock, spent waiting between
scheduler ticks: the gaps from one tick's last device mark to the next
tick's first, over consecutive ticks in the window and outside the
profiled sub-window, against those gaps plus the ticks' work. A gap after
a tick that left the engine without work is not counted
(bench/program_trace.py)."""

from bench.program_trace import tick_gap_share


def read(rec):
    return tick_gap_share(rec)
