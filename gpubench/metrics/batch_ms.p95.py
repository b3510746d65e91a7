"""The 95th percentile, over all of the window's batches, of a batch's
milliseconds from its submission to the host seeing its completion event
(host clock)."""

import statistics


def read(run):
    lat = [(b.done - b.submitted) * 1e3 for b in run.window]
    if len(lat) < 20:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]
