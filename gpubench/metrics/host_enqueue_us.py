"""Entry and dispatch: the host's microseconds inside the program's entry
call for one batch (no synchronisation inside the span), the mean over all
of the window's batches (the benchmark's own span, host clock)."""


def read(run):
    if not run.window:
        return None
    return sum(b.enqueue_s for b in run.window) / len(run.window) * 1e6
