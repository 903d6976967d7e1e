"""Share of the prompt tokens of the requests admitted in the window
that the prefix cache served (the scheduler's prefix_hit_tokens counter,
gained over the window)."""


def read(rec):
    ticks = rec.window_ticks()
    prompt = sum(rec.requests[u].prompt_tokens for t in ticks
                 for u in t.admitted)
    if not prompt:
        return None
    return 100.0 * sum(t.hit_tokens for t in ticks) / prompt
