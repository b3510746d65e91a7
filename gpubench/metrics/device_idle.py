"""The device's idle share of the traced window (%): 1 - (the union of
the device rows' intervals / the host's window around the traced
batches) (device trace)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.rows:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
