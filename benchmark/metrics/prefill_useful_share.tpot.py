"""Share of a prefill tick's rows that are real prompt tokens: tokens
written over max_batch times the tick's padded width, over the window's
prefill ticks (every tick runs all max_batch rows)."""


def read(rec):
    ticks = [t for t in rec.window_ticks() if t.kind == "prefill"]
    slots = sum(rec.engine["max_batch"] * t.width for t in ticks)
    if not slots:
        return None
    return 100.0 * sum(r[1] for t in ticks for r in t.prefill_rows) / slots
