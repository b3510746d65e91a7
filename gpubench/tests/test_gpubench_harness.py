"""The benchmark's harness on the CPU: the contract of ``BENCHMARK.json``,
the arguments, the result line, the import check, the exit without a
card, the trace's reading, and whole runs at a small size, sound, with
the control in the program's place, and with faults planted under the
timed path.  The port's plain versions stand in for its kernels here."""

import json
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from gpubench import harness
from gpubench import trace as tr

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny(cell_name):
    """A cell's configuration and traffic at a size the CPU runs fast."""
    cell = next(w for w in BENCH["workloads"] if w["name"] == cell_name)
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    config.update(hidden_size=32, intermediate_size=64,
                  num_hidden_layers=min(config["num_hidden_layers"], 3))
    traffic = json.loads((ROOT / "gpubench" / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    traffic.update(sequences=2, seq_len=8, compile=None)
    return cell, config, traffic


def run_tiny(cell_name, trace=False, **kw):
    cell, config, traffic = tiny(cell_name)
    return harness.run(cell, config, traffic, BENCH, 2 ** 31 + 99, 0.2,
                       trace, "cpu", time.perf_counter(), **kw)


CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_contract():
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    assert set(BENCH) == keys
    assert BENCH["paths"] == ["gpubench"]
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert (ROOT / "gpubench" / "datapaths" /
                f"{cfg['datapath']}.py").is_file()
        assert (ROOT / "gpubench" / "reference" /
                f"{cfg['datapath']}.py").is_file()
    pairs = set()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert (ROOT / "gpubench" / "traffic" /
                f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", ()):
            assert w in CELLS
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m


def test_arguments():
    a = harness.parse_args(["--workload", "x", "--seed", str(2 ** 33),
                            "--seconds", "15", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace, a.control) == \
        ("x", 2 ** 33, 15.0, 1, False)
    with pytest.raises(SystemExit):
        harness.parse_args(["--workload", "x", "--seed", "1",
                            "--seconds", "1", "--trace", "2"])


@pytest.mark.parametrize("cell", [c for c in CELLS if "graphs" not in c])
def test_run_is_correct_and_its_line_has_the_keys(cell):
    res, checks = run_tiny(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"sim_rate", "batch_ms.p95", "setup_s"}
    assert checks["mismatched_elements"]["value"] == 0
    assert checks["mismatched_sums"]["value"] == 0
    assert checks["compared_batches"]["value"] >= 5
    json.dumps(res)


def test_ffn_blocks_chain():
    """Each block's output is the next one's input: the stack of three
    is the third block over the second over the first."""
    from gpubench.reference import ffn_pipeline as ref
    _, config, traffic = tiny("bertl_ffn_int8.offline")
    weights, pool = harness.inputs.make(ref, config, traffic, 7, "cpu")
    assert weights["w1"].shape == (3, 32, 64)
    x = pool[0]
    for n in range(3):
        one = dict(config, num_hidden_layers=1)
        x = ref.forward(x, {k: w[n:n + 1] for k, w in weights.items()}, one)
    assert torch.equal(x, ref.forward(pool[0], weights, config))
    assert ref.work(config, traffic)["products"] == 3 * 2 * 16 * 32 * 64


def test_traced_run_reports_per_layer_metrics():
    res, _ = run_tiny("bertl_fc_tree16.fc1", trace=True)
    assert res["correct"] is True
    # no device rows on the CPU: only the host-side readings
    assert set(res["metrics"]) == {"host_enqueue_us"}
    assert "breakdown" in res and "window_s" in res["device"]


@pytest.mark.parametrize("cell", ["bertl_ffn_int8.offline",
                                  "bertl_fc_tree16.fc1"])
def test_control_fails(cell):
    res, checks = run_tiny(cell, control=True)
    assert res["correct"] is False
    assert checks["mismatched_elements"]["value"] > 0


def alter_one(fn):
    def broken(x):
        y = fn(x).clone()
        y.view(-1)[y.numel() // 2] += 1
        return y
    return broken


def drop_half(fn):
    def broken(x):
        y = fn(x[: x.shape[0] // 2])
        return torch.cat([y, torch.zeros_like(y)])
    return broken


@pytest.mark.parametrize("cell", ["bertl_ffn_int8.offline",
                                  "bertl_fc_tree16.fc2"])
@pytest.mark.parametrize("fault", [alter_one, drop_half])
def test_faults_make_the_run_incorrect(cell, fault):
    res, _ = run_tiny(cell, hook=fault)
    assert res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("cell", ["bertl_ffn_int8.offline",
                                  "bertl_fc_tree16.fc1"])
def test_one_wrong_batch_in_the_window_fails(cell):
    """One answer altered in one batch of the window, sampled or not: its
    sum differs from its pool entry's."""
    calls = [0]

    def once(fn):
        def broken(x):
            y = fn(x)
            calls[0] += 1
            if calls[0] == 40:       # past the warm-up's 10 calls
                y = y.clone()
                y.view(-1)[3] += 1
            return y
        return broken
    res, checks = run_tiny(cell, hook=once)
    assert res["attempted"] > 40
    assert checks["mismatched_sums"]["value"] == 1
    assert res["correct"] is False and res["failed"] == 1


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "qublas_tpu_torch_fake",
                        types.ModuleType("qublas_tpu_torch_fake"))
    assert "qublas_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "qublas_tpu.ops",
                        types.ModuleType("qublas_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jaxlib",
                        types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["jaxlib", "qublas_tpu"]


def loaded_by(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_port_or_jax():
    tops = loaded_by("import gpubench.reference.ffn_pipeline, "
                     "gpubench.reference.qgemul")
    assert not tops & {"qublas_tpu_torch", "qublas_tpu", "jax", "jaxlib",
                       "flax"}


def test_harness_and_datapaths_import_no_jax():
    tops = loaded_by("import gpubench.harness, gpubench.datapaths.qgemul, "
                     "gpubench.datapaths.ffn_pipeline")
    assert "qublas_tpu_torch" in tops
    assert not tops & {"qublas_tpu", "jax", "jaxlib", "flax"}


def test_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload",
         "bertl_fc_tree16.fc1", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert res.stdout == ""
    assert len(res.stderr.strip().splitlines()) == 1
    assert "CUDA" in res.stderr


def rows(*spans):
    return [{"ph": "X", "cat": "kernel", "name": n, "ts": s, "dur": d}
            for n, s, d in spans]


def test_trace_union_clip_and_gaps():
    ev = [{"ph": "X", "cat": "user_annotation", "name": tr.WINDOW,
           "ts": 100.0, "dur": 100.0, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::index",
           "ts": 150.0, "dur": 20.0, "tid": 1},
          {"ph": "X", "cat": "user_annotation", "name": "gpubench.wait",
           "ts": 140.0, "dur": 55.0, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "other thread",
           "ts": 100.0, "dur": 100.0, "tid": 2}]
    # two overlapping rows (streams) count once; a row before the window
    # is left out; the gaps: 100-110 (outside any op of the window's
    # thread), 140-160 under aten::index (its midpoint 150 is inside it,
    # and inside the wait), 180-200 under the wait
    ev += rows(("k1", 80.0, 20.0), ("k2", 110.0, 30.0), ("glue", 120.0, 10.0),
               ("k2", 160.0, 20.0))
    t = tr.parse(ev, batches=2)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(50e-6)
    assert dict(t.device_ops()) == pytest.approx(
        {"k2": 50e-6, "glue": 10e-6})
    gaps = dict(t.idle_gaps())
    assert gaps["aten::index"] == pytest.approx(20e-6)
    assert gaps["gpubench.wait"] == pytest.approx(20e-6)
    assert gaps["host outside any traced op"] == pytest.approx(10e-6)


def test_readers_on_a_synthetic_run():
    t = tr.Trace(window_s=0.010, rows=[("fused_gemm_s8_kernel<1>", 0.0,
                                        0.004),
                                       ("aten::copy", 0.004, 0.006)],
                 batches=2)
    r = harness.Run({"name": "c"}, {}, {}, {"products": 10 ** 12,
                                           "bytes": 10 ** 9},
                    {"int8_ops_per_s": 2e15, "hbm_bytes_per_s": 4e12},
                    port_kernels=tr.port_kernels(ROOT / "gpubench" /
                                                 "kernels"))
    r.trace = t
    r.window = [harness.Batch(i, 0.001 * i, 1e-4, 0.001 * i + 0.002)
                for i in range(100)]
    r.window_s = 0.101
    read = harness.load_reader
    assert read("glue_device_ms")(r) == pytest.approx(1.0)
    assert read("device_idle")(r) == pytest.approx(40.0)
    # least: 2e12 ops / 2e15 = 1 ms, over 3 ms busy a batch
    assert read("kernel_roofline")(r) == pytest.approx(100 / 3)
    assert read("host_enqueue_us")(r) == pytest.approx(100.0)
    assert read("batch_ms.p95")(r) == pytest.approx(2.0)
    assert read("sim_rate")(r) == pytest.approx(1e12 * 100 / 0.101 / 1e9)
