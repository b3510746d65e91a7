"""The experts' share of the card's peak (%): the held and the shared
experts' products (routed ones at the expected pair count) at the int8
peak, or their weights' bytes at the HBM peak, whichever is larger, over
the device time a batch of the rows launched inside the port's
``qublas.moe.experts`` spans: K1 a group and the shared expert's K1, and
the g*u glue between them (device trace; ``peaks.json``; none without
such a span or where the rows cannot be paired)."""

from gpubench import outer_spans


def read(run):
    p = run.peaks
    ms = outer_spans.device_ms(run, {"qublas.moe.experts"})
    if p is None or not ms or "expert_products" not in run.work:
        return None
    least = max(2 * run.work["expert_products"] / p["int8_ops_per_s"],
                run.work["expert_bytes"] / p["hbm_bytes_per_s"])
    return 100.0 * least / (ms / 1e3)
