"""Share of the tokens the prefill ticks compute that are real prompt
tokens: 100 x the program's ``prompt_tokens`` over its ``padded_tokens``
(the rows a tick computed times its padded width), summed over the
counted prefill ticks of the window (bench/program_trace.py)."""

from bench.program_trace import window_ticks


def read(rec):
    ticks = window_ticks(rec)
    if ticks is None:
        return None
    spans = [s for s, counted in ticks if counted
             and s.attrs.get("kind") == "prefill"
             and s.attrs.get("padded_tokens")]
    padded = sum(s.attrs["padded_tokens"] for s in spans)
    if not padded:
        return None
    return 100.0 * sum(s.attrs["prompt_tokens"] for s in spans) / padded
