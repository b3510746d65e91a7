"""One run of one cell: set-up, the measured window, the traced batches,
the check against the plain reference, and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix.  Everything particular to them is data
or a module found by name: ``configs/<config>.json`` (through
``BENCHMARK.json``'s ``file``), ``traffic/<traffic>.json``,
``datapaths/<datapath>.py`` (the program under test, built from the port's
public entry points), ``reference/<datapath>.py`` (its plain reference),
``metrics/<metric>.py`` (a reader per metric) and ``kernels/*.txt`` (the
names of the port's hand-written kernels).

Traffic is a closed loop with ``in_flight`` batches on the device: submit
batch i+1, then wait for batch i's completion event.  Batches cycle
through a pool of distinct inputs made at set-up.  Every window batch's
output is summed on the device as it completes, and the outputs of a
sample of the window's batches, drawn from the seed, are kept there.
Once the window has closed and the program is freed, the reference
works out the output of each pool entry: every batch's sum is compared
with its entry's, and every kept output element by element.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import importlib.util
import json
import random
import sys
import tempfile
import time
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import torch

from . import inputs, trace as tr

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qublas_tpu")
KEEP = 16            # window outputs compared with the reference, at most
TRACE_SECONDS = 1.0  # how long the traced batches run, about
TRACE_MIN = 8        # traced batches, at least
AT_LEAST = ("compared_batches",)   # checks held from below, not above


@dataclass
class Batch:
    index: int
    submitted: float
    enqueue_s: float
    done: float = 0.0


@dataclass
class Run:
    """What a metric's reader reads: the cell, its work a batch, the
    window's batches, set-up seconds and, in a traced run, the trace."""

    cell: dict
    config: dict
    traffic: dict
    work: dict
    peaks: Optional[dict]
    setup_s: float = 0.0
    window: list = field(default_factory=list)
    window_s: float = 0.0
    trace: Optional[tr.Trace] = None
    port_kernels: object = None


def forbidden_modules():
    """Top-level names in ``sys.modules`` that the run may not load,
    compared whole (``qublas_tpu_torch`` is not ``qublas_tpu``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def compile_counters() -> dict:
    """Dynamo's and Inductor's counters (FX graph cache hits, misses and
    bypasses among them), for the set-up line on standard error; none
    where nothing was compiled (Dynamo is not imported for them)."""
    utils = sys.modules.get("torch._dynamo.utils")
    if utils is None:
        return {}
    return {k: dict(v) for k, v in utils.counters.items()
            if k in ("inductor", "aot_autograd", "stats") and v}


def load_module(kind: str, name: str):
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def load_reader(name: str) -> Callable:
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peaks_for(kind: str):
    table = json.loads((HERE / "peaks.json").read_text())
    return next((v for k, v in table.items() if k in kind), None)


def fence(device):
    """An event marking the work enqueued so far; None on the CPU, where
    calls return with their work done."""
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def closed_loop(fn, pool, in_flight: int, seconds: float, device,
                keep: Optional[Callable] = None, annotate: bool = False,
                count: Optional[int] = None):
    """Drive ``fn`` over the pool with ``in_flight`` batches outstanding
    until ``seconds`` have passed (or ``count`` batches were submitted),
    then drain.  Returns (batches, window seconds); ``keep(i, out)`` sees
    each output once its batch completed."""
    from torch.profiler import record_function

    def span(name):
        return record_function(name) if annotate else nullcontext()

    batches, pending = [], collections.deque()
    t0 = time.perf_counter()
    end = t0 + seconds
    i = 0

    def complete():
        b, ev, out = pending.popleft()
        with span("gpubench.wait"):
            if ev is not None:
                ev.synchronize()
        b.done = time.perf_counter()
        batches.append(b)
        if keep is not None:
            keep(b.index, out)

    while (count is None and time.perf_counter() < end) or \
            (count is not None and i < count):
        x = pool[i % len(pool)]
        t = time.perf_counter()
        with span("gpubench.enqueue"):
            out = fn(x)
        b = Batch(i, t, time.perf_counter() - t)
        pending.append((b, fence(device), out))
        if len(pending) >= in_flight:
            complete()
        i += 1
    while pending:
        complete()
    return batches, (batches[-1].done - t0) if batches else 0.0


class Sample:
    """Every output's sum (int64, on the device), and a uniform sample of
    the window's outputs (reservoir sampling, its draws from the seed)
    plus the first batch of each pool entry."""

    def __init__(self, seed: int, pool: int, size: int = KEEP):
        self.rng = random.Random(seed * 7919 + 1)
        self.pool, self.size = pool, size - pool
        self.first, self.kept, self.seen = {}, [], 0
        self.sums = []

    def __call__(self, i: int, out):
        self.sums.append(out.sum(dtype=torch.int64))
        if i < self.pool:
            self.first[i] = out
            return
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append((i, out))
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.kept[j] = (i, out)

    def items(self):
        return sorted(list(self.first.items()) + self.kept,
                      key=lambda kv: kv[0])


def traced(fn, pool, in_flight, device, count):
    """Run ``count`` batches under ``torch.profiler``; the parsed trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="gpubench_") as tmp:
        with profile(activities=acts) as prof:
            with record_function(tr.WINDOW):
                closed_loop(fn, pool, in_flight, 0.0, device,
                            annotate=True, count=count)
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize()
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return tr.load(path, count)


def run_cell(bench: dict, name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, control: bool = False,
             hook: Optional[Callable] = None):
    """One run of cell ``name``.  Returns (result dict, checks dict).

    ``control``: the reference in its narrower precision stands in the
    program's place.  ``hook(fn)``: a function around the program's
    callable (the tests plant faults with it)."""
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return run(cell, config, traffic, bench, seed, seconds, trace, device,
               t_start, control, hook)


def run(cell, config, traffic, bench, seed, seconds, trace, device,
        t_start, control=False, hook=None):
    ref = load_module("reference", config["datapath"])
    cuda = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    r = Run(cell, config, traffic, ref.work(config, traffic),
            peaks_for(kind), port_kernels=tr.port_kernels(HERE / "kernels"))

    # set-up: inputs and weights from the seed, the program, its shapes
    phases = {"imports": time.perf_counter() - t_start}
    weights, pool = inputs.make(ref, config, traffic, seed, device)
    if cuda:
        torch.cuda.synchronize()
    phases["inputs"] = time.perf_counter() - t_start - sum(phases.values())
    if control:
        def fn(x):
            return ref.forward(x, weights, config, control=True)
    else:
        fn = load_module("datapaths", config["datapath"]).build(
            config, traffic, weights)
    if hook is not None:
        fn = hook(fn)
    phases["program"] = time.perf_counter() - t_start - sum(phases.values())
    in_flight = traffic["in_flight"]
    closed_loop(fn, pool, in_flight, 0.0, device, count=2 * len(pool) + 2)
    if cuda:
        torch.cuda.synchronize()
    r.setup_s = time.perf_counter() - t_start
    phases["warm_up"] = r.setup_s - sum(phases.values())
    print("gpubench: set-up seconds " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()) + "; compile counters "
        + json.dumps(compile_counters()), file=sys.stderr)

    # the window
    sample = Sample(seed, len(pool))
    r.window, r.window_s = closed_loop(fn, pool, in_flight, seconds, device,
                                       keep=sample)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        gap = r.window_s / max(len(r.window), 1)
        count = max(TRACE_MIN, round(TRACE_SECONDS / max(gap, 1e-9)))
        r.trace = traced(fn, pool, in_flight, device, count)

    # the check, with the program freed
    del fn
    if "torch._dynamo" in sys.modules:     # a compiled program's graphs
        torch._dynamo.reset()
    kept = sample.items()
    sums = torch.stack(sample.sums).cpu() if sample.sums \
        else torch.zeros(0, dtype=torch.int64)
    del sample
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    mismatched, wrong, off_sum = compare(ref, config, weights, pool, kept,
                                         sums)
    compared = len(kept)
    del kept

    metrics = {}
    wanted = bench["per_layer"] if trace else bench["end_to_end"]
    for m in wanted:
        if "workloads" in m and cell["name"] not in m["workloads"]:
            continue
        value = load_reader(m["name"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    # the numbers compared, each with its limit: at most 0 kept elements
    # and 0 batches' sums that differ, at least 1 batch compared whole
    checks = {"mismatched_elements": {"value": mismatched, "limit": 0},
              "mismatched_sums": {"value": len(off_sum), "limit": 0},
              "compared_batches": {"value": compared, "limit": 1}}
    correct = all(c["value"] >= c["limit"] if k in AT_LEAST
                  else c["value"] <= c["limit"] for k, c in checks.items())
    result = {
        "correct": bool(correct),
        "attempted": len(r.window),
        "failed": len(wrong | off_sum),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": peak},
    }
    if r.trace is not None:
        result["device"]["busy_s"] = r.trace.busy_s()
        result["device"]["window_s"] = r.trace.window_s
        result["breakdown"] = {"device_ops": r.trace.device_ops(),
                               "idle_gaps": r.trace.idle_gaps()}
    result["checks"] = checks
    return result, checks


def compare(ref, config, weights, pool, kept, sums):
    """Against the reference's output for each batch's pool entry: the
    kept outputs' elements that differ, the kept batches that differ, and
    the window's batches whose sum differs (``sums[i]`` is batch i's)."""
    want = [ref.forward(x, weights, config) for x in pool]
    want_sums = torch.stack([w.sum() for w in want]).cpu()
    entry = torch.arange(len(sums)) % len(pool)
    off_sum = set((sums != want_sums[entry]).nonzero().flatten().tolist())
    mismatched, wrong = 0, set()
    for i, out in kept:
        w = want[i % len(pool)]
        diff = int((out.long() != w).sum()) if out.shape == w.shape \
            else w.numel()
        mismatched += diff
        if diff:
            wrong.add(i)
    return mismatched, wrong, off_sum


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="put the reference, in its narrower precision, in "
                   "the program's place: the comparison must fail")
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"gpubench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"gpubench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s), found {found}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda", t_start,
                              control=args.control)
    found = forbidden_modules()
    if found:
        print(f"gpubench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for key, c in checks.items():
        rule = "at least" if key in AT_LEAST else "at most"
        print(f"check {key} {c['value']} limit {rule} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
