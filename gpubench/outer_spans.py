"""The port's spans at any depth in a parsed trace (``trace.Trace``):
``spans`` tells a device row to the innermost ``qublas.`` span around its
launch, so the rows of a GEMM inside ``qublas.moe.experts`` go to its
``qublas.qgemul``; these readers take every row launched anywhere inside
the named spans, and the host time inside them.

Rows are paired with their launches by order, as ``spans`` pairs them
(the i-th launch call of the window enqueued its i-th device row, on one
stream), except that two rows may overlap by up to ``JITTER`` (the copy
engines' clocks against the SMs').  A launch is not checked against its
row's start: the trace places the card's clock on the host's only to
within milliseconds.  Nothing is read where they cannot be paired."""

from __future__ import annotations

import bisect

from . import spans
from . import trace as tr

JITTER = 1e-6    # seconds


def _outer(t, names):
    return tr.union([(s, e) for n, s, e in t.host if n in names])


def paired(t):
    """[(row, launch call start)] of the trace ``t``, the rows in order of
    start; None where they cannot be paired (see the module's
    docstring)."""
    rows = sorted(t.rows, key=lambda r: r[1])
    calls = spans.launches(t)
    if len(calls) != len(rows) or any(
            b[1] < a[2] - JITTER for a, b in zip(rows, rows[1:])):
        return None
    return [(r, c[0]) for r, c in zip(rows, calls)]


def device_ms(run, names):
    """Device ms a traced batch (the union of their intervals) of the rows
    launched inside a span named in ``names``, at any depth; None without
    such a span, or where the rows cannot be paired."""
    t = run.trace
    if t is None or not t.rows or not t.batches:
        return None
    outer = _outer(t, names)
    pairs = paired(t) if outer else None
    if pairs is None:
        return None
    starts = [s for s, _ in outer]

    def inside(at):
        i = bisect.bisect_right(starts, at) - 1
        return i >= 0 and at < outer[i][1]

    return t.busy_s([row for row, at in pairs if inside(at)]) \
        / t.batches * 1e3


def host_us(run, names):
    """Host µs a traced batch inside the spans named in ``names`` (their
    union); None without such a span, or without a device row (the
    CPU)."""
    t = run.trace
    if t is None or not t.rows or not t.batches:
        return None
    outer = _outer(t, names)
    if not outer:
        return None
    return sum(e - s for s, e in outer) / t.batches * 1e6
