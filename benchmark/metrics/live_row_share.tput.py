"""Share of the decode rows that were live: decoding slots before each
decode tick times its steps, over max_batch times all decode steps in
the window (the arithmetic of quest_tpu_torch/exp/scheduler_load.py)."""


def read(rec):
    ticks = [t for t in rec.window_ticks() if t.kind == "decode" and t.steps]
    steps = sum(t.steps for t in ticks)
    if not steps:
        return None
    live = sum(len(t.decode_rows) * t.steps for t in ticks)
    return 100.0 * live / (rec.engine["max_batch"] * steps)
