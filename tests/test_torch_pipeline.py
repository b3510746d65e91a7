"""The torch port's quantized GEMM pipeline, ROM and QTensor against the JAX
package, Δ=0; the port's independence from JAX; chip_smoke's refusal to
run without a card; and the kernels' launch counters on CPU tensors."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from __graft_entry__ import entry
from qublas_tpu import anus as janus
from qublas_tpu.qformat import OverflowMode, qformat
from qublas_tpu.qtensor import from_raw as jfrom_raw
from qublas_tpu_torch import (QTable, QTensor, QuantPipeline, from_raw,
                              pipeline_formats, qgemul)
from qublas_tpu_torch import anus as tanus
from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm
from qublas_tpu_torch.ops.tree_gemm import tree_gemm

ROOT = Path(__file__).resolve().parent.parent


def test_pipeline_matches_jax_entry():
    forward, (x, w1, w2) = entry()
    want = np.asarray(forward(x, w1, w2))
    fa = pipeline_formats()[0]
    # weights carried over as JAX QTensors (.raw() and .fmt)
    pipe = QuantPipeline.from_numpy(jfrom_raw(w1, fa), jfrom_raw(w2, fa),
                                    "cpu")
    got = pipe(torch.from_numpy(x))
    assert got.dtype == torch.int8 and want.dtype == np.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # and as numpy raws
    pipe2 = QuantPipeline.from_numpy(w1, w2, torch.device("cpu"))
    np.testing.assert_array_equal(pipe2(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("func", ["sqrt_func", "rsqrt_func",
                                  "reciprocal_func"])
@pytest.mark.parametrize("in_fmt,out_fmt", [
    (qformat(3, 4, overflow_mode=OverflowMode.SAT_ZERO), None),
    (qformat(4, 4, signed=False), qformat(2, 9)),
    (qformat(1, 6), qformat(8, 8, overflow_mode=OverflowMode.WRP_TCPL_SAT)),
], ids=["mid", "unsigned", "wrap-word"])
def test_qtable_matches_jax(func, in_fmt, out_fmt):
    jt = janus.QTable(getattr(janus, func), in_fmt, out_fmt)
    tt = QTable(getattr(tanus, func), in_fmt, out_fmt)
    np.testing.assert_array_equal(tt.table.numpy(), jt._np_table)
    # applied to every input bit pattern
    w = in_fmt.width
    pats = np.arange(1 << w)
    raws = np.where(in_fmt.signed & (pats >= (1 << (w - 1))),
                    pats - (1 << w), pats)
    want = jt(jfrom_raw(raws, in_fmt))
    got = tt(from_raw(raws, in_fmt, "cpu"))
    assert got.fmt == want.fmt
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


def test_qtensor_lane_storage():
    fa = qformat(3, 4)
    # wart raws beyond the format's storage take a wider lane, as in JAX
    for raws in ([1, -2, 3], [1000, -3], [1 << 20]):
        j = jfrom_raw(np.array(raws), fa)
        t = from_raw(raws, fa, "cpu")
        assert t.data.dtype == getattr(torch, str(j.data.dtype))
        np.testing.assert_array_equal(t.raw(), np.asarray(j.raw()))
    t = from_raw(np.array([[3, -5]]), fa, "cpu")
    assert t.shape == (1, 2) and t.device == torch.device("cpu")
    np.testing.assert_array_equal(t.to_double(), [[3 / 16, -5 / 16]])
    assert isinstance(t.to("cpu"), QTensor) and t[0].shape == (2,)
    with pytest.raises(NotImplementedError, match="ROADMAP items 10-11"):
        from_raw([1], qformat(40, 0), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP items 10-11"):
        from_raw(np.array([1 << 70], dtype=object), fa, "cpu")


def test_cpu_tensors_launch_no_kernel():
    fused_int8_gemm.launches = 0
    tree_gemm.launches = 0
    forward, (x, w1, w2) = entry()
    QuantPipeline.from_numpy(w1, w2, "cpu")(torch.from_numpy(x[:8]))
    f = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
    a = from_raw(np.arange(12).reshape(3, 4), f, "cpu")
    qgemul(a, QTensor(a.data.t().contiguous(), f), f)
    assert fused_int8_gemm.launches == 0 and tree_gemm.launches == 0


def test_port_runs_without_jax():
    code = (
        "import sys, numpy as np, torch\n"
        "import qublas_tpu_torch as qt\n"
        "fa = qt.pipeline_formats()[0]\n"
        "rng = np.random.RandomState(0)\n"
        "w = [rng.randint(-128, 128, (32, 32)).astype(np.int8) for _ in"
        " range(3)]\n"
        "y = qt.QuantPipeline.from_numpy(w[1], w[2], 'cpu')("
        "torch.from_numpy(w[0]))\n"
        "assert y.shape == (32, 32)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no CUDA device" in res.stderr
