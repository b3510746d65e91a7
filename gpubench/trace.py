"""Reading a ``torch.profiler`` (Kineto) trace of the traced batches.

A copy of ``qublas_tpu_torch.utils.profiling.parse_trace_events`` with
two repairs: device time is the union of the device rows' intervals, so
rows that overlap on two streams count once, and it is clipped to the
host's window (the ``gpubench.window`` range around the traced batches),
so idle time before the first row and after the last one counts as idle.
"""

from __future__ import annotations

import bisect
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "gpubench.window"
TOP = 10
NAME_CHARS = 160     # a breakdown's names, cut to this length


@dataclass
class Trace:
    """The traced window: its host seconds, the device rows inside it as
    (name, start, end) in seconds, and the host events of the thread that
    drove it."""

    window_s: float
    rows: list
    host: list = field(default_factory=list)
    batches: int = 0

    def busy_s(self, rows=None) -> float:
        """Seconds in which some device row of ``rows`` ran."""
        return sum(e - s for s, e in union(rows if rows is not None
                                           else self.rows))

    def idle_gaps(self):
        """[(host event name, seconds)] of the device's idle gaps, each
        named by the innermost host event under its midpoint."""
        gaps, t = [], 0.0
        for s, e in union(self.rows) + [(self.window_s, self.window_s)]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        named: dict = {}
        for s, e in gaps:
            name = innermost(host, starts, (s + e) / 2)
            named[name] = named.get(name, 0.0) + (e - s)
        return top(named)

    def device_ops(self):
        by: dict = {}
        for name, s, e in self.rows:
            by[name] = by.get(name, 0.0) + (e - s)
        return top(by)


def innermost(host, starts, t):
    """The name of the latest-starting host event that covers ``t``: on
    one thread, events nest, so that is the innermost."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if host[i][2] > t:
            return host[i][0]
    return "host outside any traced op"


def union(rows):
    """Sorted disjoint (start, end) intervals covering the rows."""
    out = []
    for s, e in sorted((r[1], r[2]) if len(r) == 3 else r for r in rows):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def top(by: dict):
    return [[k[:NAME_CHARS], v] for k, v in
            sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def parse(events: list, batches: int) -> Trace:
    """Kineto's ``traceEvents`` -> the :class:`Trace` of the window."""
    wins = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not wins:
        raise ValueError(f"no {WINDOW} range in the trace")
    w = max(wins, key=lambda e: e.get("dur", 0.0))
    t0, t1 = w["ts"], w["ts"] + w.get("dur", 0.0)

    def clip(e):
        s, d = max(e["ts"], t0), min(e["ts"] + e.get("dur", 0.0), t1)
        return (e["name"], (s - t0) / 1e6, (d - t0) / 1e6) if d > s else None

    rows = [c for e in events if e.get("ph") == "X"
            and e.get("cat") in DEVICE_CATS and (c := clip(e))]
    host = [c for e in events if e.get("ph") == "X"
            and e.get("cat") in HOST_CATS and e.get("tid") == w.get("tid")
            and e.get("name") != WINDOW and (c := clip(e))]
    return Trace((t1 - t0) / 1e6, rows, host, batches)


def load(path, batches: int) -> Trace:
    with open(path) as f:
        return parse(json.load(f).get("traceEvents", []), batches)


def port_kernels(directory: Path):
    """A pattern matching the names in every ``*.txt`` under
    ``directory`` (one a line, ``#`` comments)."""
    names = []
    for p in sorted(Path(directory).glob("*.txt")):
        for line in p.read_text().splitlines():
            line = line.split("#", 1)[0].strip()
            if line:
                names.append(re.escape(line))
    return re.compile(r"\b(" + "|".join(names) + r")\b") if names else None
