"""Simulated quantized products completed a second (Gprod/s): the sum of
M*N*K over every GEMM of every batch finished in the window, over the
window's seconds (first submission to last completion, host clock)."""


def read(run):
    if not run.window or run.window_s <= 0:
        return None
    return run.work["products"] * len(run.window) / run.window_s / 1e9
