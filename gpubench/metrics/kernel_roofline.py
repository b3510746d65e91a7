"""The datapath's least time on the card over the device's busy time a
batch (%).  The least time is the larger of 2 * sum(M*N*K) operations at
the published int8 peak and the bytes of every input, weight and output
read or written once at the HBM peak: the work any implementation must
do, so no fusion, rename or reroute can take it over 100% (device trace;
``peaks.json``)."""


def read(run):
    t, p = run.trace, run.peaks
    if t is None or p is None or not t.batches:
        return None
    busy = t.busy_s() / t.batches
    if busy <= 0:
        return None
    least = max(2 * run.work["products"] / p["int8_ops_per_s"],
                run.work["bytes"] / p["hbm_bytes_per_s"])
    return 100.0 * least / busy
