"""The port's own spans in a parsed trace (``trace.Trace``): the host
time inside the ``qublas.`` ranges that ``qublas_tpu_torch.utils.profiling
.span`` opens, and the device rows launched inside them.

A device row runs where the card gets to it, often after the range that
launched it has ended, so a row is told to a range by its launch: the
runtime (or driver) call on the driving thread that enqueued it.  The
trace keeps no correlation ids, so the calls and the rows are paired in
order, which holds on one stream, where the card runs its work in the
order it was enqueued: the i-th launch call of the window enqueued its
i-th device row.  Where that cannot hold (rows that overlap, as two
streams give, or as many launch calls as rows not found) nothing is
paired, and the readers give nothing.
"""

from __future__ import annotations

import re

from . import trace as tr

PREFIX = "qublas."
# the host calls that enqueue one device row each: kernel launches, copies
# and sets, runtime or driver (not a graph's launch, which enqueues many,
# nor a host function, which enqueues none)
LAUNCH = re.compile(r"^cu(da)?(Launch(Kernel|Cooperative)|Memcpy|Memset)")


def host_us(run, name: str):
    """Host µs a traced batch inside the spans named ``name`` (their
    union); None without such a span, or without a device row (the
    CPU)."""
    t = run.trace
    if t is None or not t.rows or not t.batches:
        return None
    spans = [(s, e) for n, s, e in t.host if n == name]
    if not spans:
        return None
    return sum(e - s for s, e in tr.union(spans)) / t.batches * 1e6


def launches(t):
    """The launch calls of the window, in order, as (start, end): each a
    host call that enqueues one device row, a call inside another one
    (the driver under the runtime) counted with it."""
    out = []
    for n, s, e in sorted(t.host, key=lambda h: h[1]):
        if LAUNCH.match(n) and not (out and e <= out[-1][1]):
            out.append((s, e))
    return out


def launch_spans(t):
    """For each device row of ``t`` in order of start, as (row, span): the
    name of the innermost ``qublas.`` span around the call that launched
    it, or None where no such span is; None where the rows cannot be
    paired with their launches (see the module's docstring)."""
    rows = sorted(t.rows, key=lambda r: r[1])
    calls = launches(t)
    if len(calls) != len(rows) or any(
            b[1] < a[2] for a, b in zip(rows, rows[1:])):
        return None
    spans = sorted((h for h in t.host if h[0].startswith(PREFIX)),
                   key=lambda h: h[1])
    starts = [h[1] for h in spans]
    names = (tr.innermost(spans, starts, s) for s, _ in calls)
    return [(row, n if n.startswith(PREFIX) else None)
            for row, n in zip(rows, names)]


def device_ms(run, name: str):
    """Device ms a traced batch (the union of their intervals) of the rows
    launched inside a span named ``name`` (the innermost ``qublas.``
    one); None without such a span, or where the rows cannot be
    paired."""
    t = run.trace
    if t is None or not t.rows or not t.batches:
        return None
    if not any(n == name for n, _, _ in t.host):
        return None
    paired = launch_spans(t)
    if paired is None:
        return None
    return t.busy_s([r for r, n in paired if n == name]) / t.batches * 1e3
