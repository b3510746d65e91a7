"""``qublas_tpu_torch.utils.profiling``: the port of
``qublas_tpu.utils.profiling`` on ``torch.profiler``.

The parser is pure, so it is pinned here against synthetic Kineto
Chrome-trace events shaped like a trace of the card (kernel, memcpy and
memset rows on the device's stream, a ``gpu_user_annotation`` spanning a
``record_function`` range's device work, host rows of the CPU ops, the
runtime calls and the range itself), as ``tests/test_profiling.py`` pins
the JAX parser against its trace-viewer events.  On the CPU there is no
device row: ``device_busy`` gives None and cleans up after itself, and
``trace`` writes its file.  The exports match the JAX package's, and the
module, like a compiled sharded call, imports no JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from qublas_tpu_torch.utils import profiling as P
from qublas_tpu_torch.utils.profiling import parse_trace_events

ROOT = Path(__file__).resolve().parent.parent
K1 = "fused_gemm_s8_kernel(CUtensorMap, CUtensorMap, void*, int)"


def _ev(cat, name, ts, dur, pid=0, tid=7):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur}


def _card_trace():
    return [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python 123"}},
        # host rows: the range, the CPU ops and the runtime calls
        _ev("user_annotation", "pipeline compiled", 900.0, 9000.0, 123, 1),
        _ev("cpu_op", "qublas::fused_gemm_s8", 950.0, 40.0, 123, 1),
        _ev("cuda_runtime", "cudaLaunchKernel", 960.0, 8.0, 123, 1),
        _ev("cuda_runtime", "cudaMemcpyAsync", 1000.0, 5.0, 123, 1),
        # device rows: the range on the device, two K1 launches, a copy, a
        # set and a small kernel
        _ev("gpu_user_annotation", "pipeline compiled", 1000.0, 6000.0),
        _ev("kernel", K1, 1000.0, 2500.0),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 3600.0, 20.0),
        _ev("gpu_memset", "Memset (Device)", 3700.0, 3.0),
        _ev("kernel", "triton_poi_fused_index_0", 3800.0, 150.0),
        _ev("kernel", K1, 4400.0, 2600.0),
    ]


def test_parse_device_rows():
    p = parse_trace_events(_card_trace())
    assert p is not None
    busy = 2500.0 + 20.0 + 3.0 + 150.0 + 2600.0
    assert abs(p["busy_s"] - busy / 1e6) < 1e-12
    # span: the first device row's start to the last one's end
    assert abs(p["span_s"] - (7000.0 - 1000.0) / 1e6) < 1e-12
    assert abs(p["module_s"] - 6000.0 / 1e6) < 1e-12
    # rows by name, the copy and the set apart; no host row
    assert abs(p["ops"][K1] - 5100.0 / 1e6) < 1e-12
    assert abs(p["ops"]["Memcpy HtoD (Pageable -> Device)"] - 20e-6) < 1e-12
    assert abs(p["ops"]["Memset (Device)"] - 3e-6) < 1e-12
    assert not {"cudaLaunchKernel", "qublas::fused_gemm_s8",
                "pipeline compiled"} & set(p["ops"])
    assert abs(sum(p["ops"].values()) - p["busy_s"]) < 1e-12


def test_parse_overlapping_rows_count_once():
    """Two rows that overlap (two streams) count once in ``busy_s``: the
    union of their intervals, as the card was busy; ``ops`` keeps each
    row's own time."""
    p = parse_trace_events([
        _ev("kernel", K1, 100.0, 50.0, tid=7),
        _ev("kernel", "triton_poi_fused_index_0", 120.0, 60.0, tid=8),
        _ev("gpu_memset", "Memset (Device)", 200.0, 10.0, tid=7)])
    assert abs(p["busy_s"] - (80.0 + 10.0) / 1e6) < 1e-12
    assert abs(p["span_s"] - 110.0 / 1e6) < 1e-12
    assert abs(sum(p["ops"].values()) - 120.0 / 1e6) < 1e-12


def test_parse_no_device_rows_returns_none():
    # a CPU trace: host rows only -> None (callers fall back to wall time)
    ev = [_ev("cpu_op", "aten::add", 0.0, 100.0, 123, 1),
          _ev("user_annotation", "step", 0.0, 200.0, 123, 1),
          {"ph": "M", "name": "process_name", "pid": 123,
           "args": {"name": "python 123"}}]
    assert parse_trace_events(ev) is None
    assert parse_trace_events([]) is None


def test_parse_module_missing_is_none_field():
    # kernel rows with no record_function range around them
    p = parse_trace_events([_ev("kernel", K1, 10.0, 50.0)])
    assert p is not None and p["module_s"] is None
    assert abs(p["busy_s"] - 50.0 / 1e6) < 1e-12
    assert abs(p["span_s"] - 50.0 / 1e6) < 1e-12


def test_annotation_preferred_for_module(monkeypatch):
    """``module_s`` is the device span of the range (the longest
    ``gpu_user_annotation``), not the host range around it, nor the
    longest kernel, nor the kernels' sum; ``timing.device_us`` reads its
    per-kernel times through the same parser."""
    from qublas_tpu_torch import timing

    ev = _card_trace() + [
        _ev("gpu_user_annotation", "a shorter range", 8000.0, 300.0)]
    p = parse_trace_events(ev)
    assert abs(p["module_s"] - 6000.0 / 1e6) < 1e-12
    assert p["module_s"] != p["busy_s"]

    calls = []

    def fake_device_busy(run):
        run()
        return parse_trace_events(_card_trace())

    monkeypatch.setattr(P, "device_busy", fake_device_busy)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    us = timing.device_us(lambda: calls.append(1), runs=4)
    assert len(calls) == 5               # the warm-up and the four runs
    assert abs(us[K1[:60]] - 5100.0 / 4) < 1e-9
    assert abs(sum(us.values()) - (2500.0 + 20.0 + 3.0 + 150.0 + 2600.0)
               / 4) < 1e-9


def test_device_busy_on_cpu_is_none_and_cleans_up(monkeypatch, tmp_path):
    made, real = [], tempfile.mkdtemp

    def mkdtemp(prefix=None):
        made.append(real(prefix=prefix, dir=str(tmp_path)))
        return made[-1]

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    ran = []
    assert P.device_busy(lambda: ran.append(torch.ones(8).sum())) is None
    assert ran and len(made) == 1
    assert not os.path.exists(made[0]) and list(tmp_path.iterdir()) == []


def test_trace_writes_under_logdir(tmp_path):
    logdir = tmp_path / "run"
    with P.trace(str(logdir)):
        (torch.arange(16) * 3).sum()
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    ev = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in ev)
    # a CPU trace has no device row
    assert parse_trace_events(ev) is None


def test_roofline_report_keys_and_positivity():
    a = torch.from_numpy(np.random.RandomState(3).randint(
        -8, 8, (32, 32))).to(torch.int32)
    b = torch.eye(32, dtype=torch.int32)

    def fn(x, y):
        return x @ y

    rep = P.roofline_report(fn, a, b, 2 * 32 ** 3, baseline_fn=fn, iters=4)
    assert set(rep) == {"seconds_per_call", "gops", "baseline_gops",
                        "fraction_of_roofline"}
    assert all(v > 0 for v in rep.values())
    alone = P.roofline_report(fn, a, b, 2 * 32 ** 3, iters=2, ab_rounds=1)
    assert set(alone) == {"seconds_per_call", "gops"}
    assert P.timeit_chained(fn, a, b, iters=3) > 0


def test_exports_match_the_jax_package():
    import qublas_tpu
    import qublas_tpu.utils as jutils
    import qublas_tpu.utils.profiling as jprof

    import qublas_tpu_torch
    import qublas_tpu_torch.utils as tutils

    assert set(qublas_tpu.__all__) <= set(qublas_tpu_torch.__all__)
    from qublas_tpu_torch import FULL_PREC, FullPrec

    assert isinstance(FULL_PREC, FullPrec) and repr(FULL_PREC) == "FullPrec"
    assert tutils.__all__ == jutils.__all__
    assert P.__all__ == jprof.__all__
    for mod in (qublas_tpu_torch, tutils, P):
        for name in mod.__all__:
            assert getattr(mod, name) is not None, name


def test_profiling_and_compiled_sharding_import_no_jax():
    """In a fresh interpreter: ``utils.profiling`` used, and a sharded call
    compiled (``aot_eager``) in a world of one, with no JAX module and
    nothing of ``qublas_tpu`` loaded."""
    code = (
        "import sys, torch\n"
        "import qublas_tpu_torch as qt\n"
        "from qublas_tpu_torch.utils import profiling, roofline_report\n"
        "assert profiling.device_busy(lambda: torch.ones(4) + 1) is None\n"
        "import torch.distributed as dist\n"
        "from qublas_tpu_torch import parallel as par\n"
        "from qublas_tpu_torch.parallel import sharding\n"
        "assert par.init_distributed(backend='gloo') == 1\n"
        "mesh = par.make_mesh(1, 1, 'cpu', {'backend': 'aot_eager'})\n"
        "eager = par.make_mesh(1, 1, 'cpu')\n"
        "assert eager.programs is None and mesh.programs\n"
        "sa = qt.random_fill((4, 8), qt.qformat(3, 4), device='cpu')\n"
        "sb = qt.random_fill((8, 4), qt.qformat(3, 4), seed=5, device='cpu')\n"
        "kw = dict(mul_to=qt.qformat(20, 8),"
        " add_formats=(qt.qformat(20, 8),))\n"
        "got = par.sharded_qgemul_k(sa, sb, qt.qformat(3, 4), mesh, **kw)\n"
        "want = par.sharded_qgemul_k(sa, sb, qt.qformat(3, 4), eager, **kw)\n"
        "assert got.raw_list() == want.raw_list()\n"
        "assert len(sharding._PROGRAM_CACHE) == 1\n"
        "assert mesh.stats == eager.stats, (mesh.stats, eager.stats)\n"
        "dist.destroy_process_group()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'qublas_tpu' or m.startswith('qublas_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
