"""The readers of the port's spans (``gpubench/spans.py``:
``qgemul_host_us``, ``plan_host_us``, ``rom_device_ms``) on synthetic
Kineto traces shaped as the card's: host ranges, CPU ops and runtime and
driver calls on the driving thread, device rows on their stream, each row
and its launch carrying the same ``correlation`` id as Kineto writes
them.  The readers pair rows with launches by their order; the test
checks the pairing against the ids."""

from pathlib import Path

import pytest

from gpubench import harness, spans
from gpubench import trace as tr

ROOT = Path(__file__).resolve().parents[2]

K1 = "fused_gemm_s8_kernel<1>"


def host(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def row(cat, name, ts, dur, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": 7, "pid": 0, "args": {"correlation": corr, "stream": 7}}


def block_trace():
    """One traced batch of one FFN block, as the eager pipeline runs it (µs
    from the window's start): a ``qgemul`` (its plan, then K1's launch,
    the runtime call with the driver's inside it), the ROM (a mask, a set
    and the gather, which the card runs after the ROM's span has ended),
    the cast outside any port span, the second ``qgemul``; an event
    recorded, no row; a launch on another thread, not the window's."""
    ev = [host("user_annotation", tr.WINDOW, 0.0, 1000.0),
          host("user_annotation", "gpubench.enqueue", 10.0, 390.0),
          host("user_annotation", "qublas.qgemul", 20.0, 100.0),
          host("user_annotation", "qublas.plan", 25.0, 35.0),
          host("cpu_op", "qublas::fused_gemm_s8", 70.0, 40.0),
          host("cuda_runtime", "cudaLaunchKernel", 80.0, 10.0, 1),
          host("cuda_driver", "cuLaunchKernel", 82.0, 6.0, 1),
          host("user_annotation", "qublas.rom", 130.0, 70.0),
          host("cpu_op", "aten::bitwise_and", 135.0, 15.0),
          host("cuda_runtime", "cudaLaunchKernel", 140.0, 5.0, 2),
          host("cuda_runtime", "cudaMemsetAsync", 150.0, 5.0, 3),
          host("cuda_runtime", "cudaLaunchKernel", 160.0, 5.0, 4),
          host("cpu_op", "aten::clamp", 210.0, 20.0),
          host("cuda_runtime", "cudaLaunchKernel", 215.0, 5.0, 5),
          host("user_annotation", "qublas.qgemul", 240.0, 90.0),
          host("user_annotation", "qublas.plan", 245.0, 35.0),
          host("cuda_runtime", "cudaLaunchKernel", 300.0, 10.0, 6),
          host("cuda_runtime", "cudaEventRecord", 340.0, 2.0),
          host("user_annotation", "gpubench.wait", 400.0, 500.0),
          host("cuda_runtime", "cudaEventSynchronize", 405.0, 490.0),
          host("cuda_runtime", "cudaLaunchKernel", 500.0, 5.0, 9, tid=2)]
    ev += [row("kernel", K1, 100.0, 200.0, 1),
           row("kernel", "bitwise_and_kernel", 300.0, 50.0, 2),
           row("gpu_memset", "Memset (Device)", 350.0, 10.0, 3),
           row("kernel", "index_elementwise_kernel", 360.0, 90.0, 4),
           row("kernel", "clamp_kernel", 450.0, 30.0, 5),
           row("kernel", K1, 480.0, 220.0, 6)]
    return ev


def run_of(events, batches=1):
    r = harness.Run({"name": "c"}, {}, {}, {"products": 10 ** 9,
                                           "bytes": 10 ** 6},
                    {"int8_ops_per_s": 2e15, "hbm_bytes_per_s": 4e12},
                    port_kernels=tr.port_kernels(ROOT / "gpubench" /
                                                 "kernels"))
    r.trace = tr.parse(events, batches)
    return r


def read(name, r):
    return harness.load_reader(name)(r)


def test_readers_on_a_block():
    r = run_of(block_trace())
    # the two calls' spans, 100 + 90 µs; their plans, 35 + 35
    assert read("qgemul_host_us", r) == pytest.approx(190.0)
    assert read("plan_host_us", r) == pytest.approx(70.0)
    assert read("plan_host_us", r) < read("qgemul_host_us", r)
    # the ROM's rows run 300-450 µs, after its span (130-200) has ended
    assert read("rom_device_ms", r) == pytest.approx(0.150)
    # the glue: every row but K1's, 300-480 µs; the ROM a part of it
    assert read("glue_device_ms", r) == pytest.approx(0.180)
    assert read("rom_device_ms", r) < read("glue_device_ms", r)


def test_pairing_matches_the_correlation_ids():
    """Each row's launch, as the readers pair them by order, is the call
    that carries the row's correlation id: the span each row is told to
    is the one around that call."""
    ev = block_trace()
    t = tr.parse(ev, 1)
    paired = spans.launch_spans(t)
    assert paired is not None and len(paired) == 6
    win = next(e for e in ev if e["name"] == tr.WINDOW)
    calls = {e["args"]["correlation"]: (e["ts"] - win["ts"]) / 1e6
             for e in ev if e["cat"] == "cuda_runtime" and "args" in e
             and e["tid"] == win["tid"]}
    by_start = {(e["ts"] - win["ts"]) / 1e6: e["args"]["correlation"]
                for e in ev if e["cat"] in tr.DEVICE_CATS}
    host_spans = sorted((h for h in t.host if h[0].startswith("qublas.")),
                        key=lambda h: h[1])
    starts = [h[1] for h in host_spans]
    for (name, s, _), got in paired:
        want = tr.innermost(host_spans, starts, calls[by_start[s]])
        assert got == (want if want.startswith("qublas.") else None), name
    assert [n for _, n in paired] == [
        "qublas.qgemul", "qublas.rom", "qublas.rom", "qublas.rom", None,
        "qublas.qgemul"]


@pytest.mark.parametrize("fault", ["row_without_launch", "launch_without_row",
                                   "overlapping_rows"])
def test_rom_reads_nothing_where_rows_cannot_be_paired(fault):
    """A row with no launch on the window's thread, a launch whose row is
    missing, or rows that overlap (two streams): the ROM's time is not
    guessed; the host readings stand."""
    ev = block_trace()
    if fault == "row_without_launch":
        ev.append(row("kernel", "other", 710.0, 10.0, 20))
    elif fault == "launch_without_row":
        ev.append(host("cuda_runtime", "cudaMemcpyAsync", 335.0, 3.0, 21))
    else:
        ev.append(row("kernel", "other", 320.0, 10.0, 9))
        ev.append(host("cuda_runtime", "cudaLaunchKernel", 170.0, 3.0, 9))
    r = run_of(ev)
    assert read("rom_device_ms", r) is None
    assert read("qgemul_host_us", r) == pytest.approx(190.0)


def test_without_port_spans_the_readers_give_nothing():
    """The trace of a program that opens no port span (the parent of the
    change that added them): the three readers give nothing, and raise
    nothing; so does a trace with no device row (the CPU)."""
    ev = [e for e in block_trace() if not e["name"].startswith("qublas.")]
    r = run_of(ev)
    for name in ("qgemul_host_us", "plan_host_us", "rom_device_ms"):
        assert read(name, r) is None, name
    cpu = run_of([e for e in block_trace() if e["tid"] != 7])
    for name in ("qgemul_host_us", "plan_host_us", "rom_device_ms"):
        assert read(name, cpu) is None, name
    nothing = run_of(block_trace())
    nothing.trace = None
    for name in ("qgemul_host_us", "plan_host_us", "rom_device_ms"):
        assert read(name, nothing) is None, name


@pytest.mark.parametrize("with_spans", [False, True])
def test_existing_readers_read_as_before(with_spans):
    """``test_readers_on_a_synthetic_run``'s trace and window: every
    reader there reads the same with the port's spans on the host as
    without them."""
    t = tr.Trace(window_s=0.010, rows=[("fused_gemm_s8_kernel<1>", 0.0,
                                        0.004),
                                       ("aten::copy", 0.004, 0.006)],
                 batches=2)
    if with_spans:
        t.host = [("qublas.qgemul", 0.0, 0.001), ("qublas.plan", 0.0002,
                                                   0.0005),
                  ("cudaLaunchKernel", 0.0006, 0.0007),
                  ("qublas.rom", 0.002, 0.003),
                  ("cudaLaunchKernel", 0.0021, 0.0022)]
    r = harness.Run({"name": "c"}, {}, {}, {"products": 10 ** 12,
                                           "bytes": 10 ** 9},
                    {"int8_ops_per_s": 2e15, "hbm_bytes_per_s": 4e12},
                    port_kernels=tr.port_kernels(ROOT / "gpubench" /
                                                 "kernels"))
    r.trace = t
    r.window = [harness.Batch(i, 0.001 * i, 1e-4, 0.001 * i + 0.002)
                for i in range(100)]
    r.window_s = 0.101
    assert read("glue_device_ms", r) == pytest.approx(1.0)
    assert read("device_idle", r) == pytest.approx(40.0)
    assert read("kernel_roofline", r) == pytest.approx(100 / 3)
    assert read("host_enqueue_us", r) == pytest.approx(100.0)
    assert read("batch_ms.p95", r) == pytest.approx(2.0)
    assert read("sim_rate", r) == pytest.approx(1e12 * 100 / 0.101 / 1e9)
    news = [read(n, r) for n in ("qgemul_host_us", "plan_host_us",
                                 "rom_device_ms")]
    if with_spans:
        # 1 ms and 0.3 ms of host spans over 2 batches; the copy (the
        # second launch's row) ran 2 ms: 1 ms a batch
        assert news == pytest.approx([500.0, 150.0, 1.0])
    else:
        assert news == [None, None, None]
