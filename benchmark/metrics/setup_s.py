"""Set-up seconds: from the start of the run's process until the window
opens (building or loading the kernels, the weights, the engine, the
documents' prefill, the warm-up)."""


def read(rec):
    return rec.setup_s
