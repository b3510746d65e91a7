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
from qublas_tpu_torch.convert import port_format as P
from qublas_tpu_torch.ops.fused_gemm import fused_int8_gemm
from qublas_tpu_torch.ops.reduce import qreduce, qreduce_kernel
from qublas_tpu_torch.ops.tree_gemm import (plan_tree, tree_gemm,
                                            tree_gemm_stream)

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
    tt = QTable(getattr(tanus, func), P(in_fmt),
                None if out_fmt is None else P(out_fmt))
    np.testing.assert_array_equal(tt.table.numpy(), jt._np_table)
    # applied to every input bit pattern
    w = in_fmt.width
    pats = np.arange(1 << w)
    raws = np.where(in_fmt.signed & (pats >= (1 << (w - 1))),
                    pats - (1 << w), pats)
    want = jt(jfrom_raw(raws, in_fmt))
    got = tt(from_raw(raws, P(in_fmt), "cpu"))
    assert got.fmt == P(want.fmt)
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


def test_qtensor_lane_storage():
    fa = P(qformat(3, 4))
    # wart raws beyond the format's storage take a wider lane, as in JAX
    for raws in ([1, -2, 3], [1000, -3], [1 << 20]):
        j = jfrom_raw(np.array(raws), qformat(3, 4))
        t = from_raw(raws, fa, "cpu")
        assert t.data.dtype == getattr(torch, str(j.data.dtype))
        np.testing.assert_array_equal(t.raw(), np.asarray(j.raw()))
    t = from_raw(np.array([[3, -5]]), fa, "cpu")
    assert t.shape == (1, 2) and t.device == torch.device("cpu")
    np.testing.assert_array_equal(t.to_double(), [[3 / 16, -5 / 16]])
    assert isinstance(t.to("cpu"), QTensor) and t[0].shape == (2,)
    # 41-bit storage is pair storage: one int64 (the JAX package's pair)
    t = from_raw([1, -(1 << 40)], P(qformat(40, 0)), "cpu")
    assert t.is_pair and t.data.dtype == torch.int64
    np.testing.assert_array_equal(
        t.raw(), np.asarray(jfrom_raw(np.array([1, -(1 << 40)]),
                                      qformat(40, 0)).raw()))
    # 71-bit storage is limb storage: three 32-bit limbs (in int64)
    t = from_raw([1, -(1 << 70)], P(qformat(70, 0)), "cpu")
    assert t.is_limb and t.data.nlimbs == 3 and t.shape == (2,)
    np.testing.assert_array_equal(
        t.raw(), np.asarray(jfrom_raw(np.array([1, -(1 << 70)], dtype=object),
                                      qformat(70, 0)).raw()))
    # raws beyond the storage word take host storage, as in the JAX package
    t = from_raw(np.array([1 << 70], dtype=object), fa, "cpu")
    j = jfrom_raw(np.array([1 << 70], dtype=object), qformat(3, 4))
    assert t.is_host and j.is_host
    np.testing.assert_array_equal(t.raw(), np.asarray(j.raw()))


def test_cpu_tensors_launch_no_kernel():
    counters = (fused_int8_gemm, tree_gemm, tree_gemm_stream, qreduce_kernel)
    for fn in counters:
        fn.launches = 0
    forward, (x, w1, w2) = entry()
    QuantPipeline.from_numpy(w1, w2, "cpu")(torch.from_numpy(x[:8]))
    f = P(qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO))
    a = from_raw(np.arange(12).reshape(3, 4), f, "cpu")
    bt = a.data.t().contiguous()
    qgemul(a, QTensor(bt, f), f)
    tree_gemm_stream(a.data, bt, plan_tree(f, f, f, (), 4, f), f)
    qreduce(a, axis=1)
    assert [fn.launches for fn in counters] == [0, 0, 0, 0]


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
        "f = qt.qformat(4, 4)\n"
        "x = qt.random_fill((8, 13), f, device='cpu')\n"
        "r = qt.qreduce(x, (qt.qformat(5, 3), qt.qformat(6, 2)), axis=1)\n"
        "assert r.shape == (8,)\n"
        "assert (qt.qmul(x, x) + x).shape == (8, 13)\n"
        "p = qt.qmul(qt.random_fill((8, 13), qt.qformat(8, 8), device='cpu'),"
        " qt.random_fill((8, 13), qt.qformat(8, 8), seed=2, device='cpu'),"
        " full_prec=True)\n"
        "assert p.is_pair and (p + p).is_pair and (-p).is_pair\n"
        "s = qt.qreduce(p, (qt.qformat(30, 16),), axis=1)\n"
        "assert s.is_pair and s.shape == (8,)\n"
        "from qublas_tpu_torch import bitstream, complex\n"
        "from qublas_tpu_torch.ops import cgemm, chain_probe\n"
        "f34, w, m = qt.qformat(3, 4), qt.qformat(20, 8), qt.qformat(5, 4)\n"
        "c = complex.complex_from_raw(rng.randint(-128, 128, (4, 6)),"
        " rng.randint(-128, 128, (4, 6)), f34, device='cpu')\n"
        "d = complex.complex_from_raw(rng.randint(-128, 128, (6, 3)),"
        " rng.randint(-128, 128, (6, 3)), f34, device='cpu')\n"
        "y = cgemm.cgemul(c, d, f34, algo='tf', add_formats=(w,), ab=m,"
        " cd=m, ba=m, abc=w, cdb=w, bad=w, AB=w, BC=w)\n"
        "assert y.shape == (4, 3) and len(y.to_bits()) == 12 * 16\n"
        "assert chain_probe.T1 == 128 and bitstream.r2l(2).chunk == 2\n"
        "from qublas_tpu_torch.ops import gemm\n"
        "f70 = qt.qformat(70, 10)\n"
        "u = qt.random_fill((4, 5), f70, device='cpu')\n"
        "v = qt.qmul(u, u, to=qt.qformat(141, 20))\n"
        "assert v.is_limb and (v - v).is_limb and v.shape == (4, 5)\n"
        "g = gemm.qgemul(qt.random_fill((3, 8), f70, device='cpu'),"
        " qt.random_fill((8, 2), f70, seed=2, device='cpu'),"
        " qt.qformat(152, 20), mul_to=qt.qformat(141, 20),"
        " add_formats=(qt.qformat(152, 20),))\n"
        "assert g.is_limb and g.shape == (3, 2)\n"
        "bb = gemm.qgemul(qt.random_fill((2, 3, 8), fa, device='cpu'),"
        " qt.random_fill((8, 5), fa, seed=3, device='cpu'), fa,"
        " mul_to=qt.qformat(20, 8), add_formats=(qt.qformat(20, 8),))\n"
        "assert bb.shape == (2, 3, 5)\n"
        "seg = [qt.Segment(0.0, [qt.scalar(0.5, f, device='cpu')]),"
        " qt.Segment(1.0, [qt.scalar(-1.0, f, device='cpu'), x[0, 0]])]\n"
        "assert qt.qapprox(x, seg).shape == (8, 13)\n"
        "assert qt.bitwise.qxor(x, u[:1, :1]).is_limb\n"
        "import tempfile, os\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    qt.save(os.path.join(d, 'c.npz'), {'x': x, 'u': u, 'p': p})\n"
        "    back = qt.load(os.path.join(d, 'c.npz'), device='cpu')\n"
        "assert back['u'].raw_list() == u.raw_list() and back['p'].is_pair\n"
        "rf = qt.reference_fill((4, 4), qt.qformat(8, 8), device='cpu')\n"
        "assert qt.reference_shuffle(rf).shape == (4, 4)\n"
        "from qublas_tpu_torch import native\n"
        "h = qt.random_fill((2, 3), qt.qformat(600, 600), device='cpu')\n"
        "assert h.is_host and native.available()\n"
        "hh = gemm.qgemul(h, qt.random_fill((3, 2), qt.qformat(600, 600),"
        " device='cpu'), qt.qformat(600, 600))\n"
        "assert hh.is_host and qt.qreduce(qt.qmul(h, h)).is_host\n"
        "assert not qt.qcast(h, f).is_host and qt.load is not None\n"
        "hy = gemm.qgemul(qt.random_fill((3, 48), qt.qformat(3, 4),"
        " device='cpu'), qt.random_fill((48, 2), qt.qformat(3, 4), seed=4,"
        " device='cpu'), qt.qformat(5, 4), mul_to=qt.qformat(7, 8),"
        " add_formats=(qt.qformat(8, 8), qt.qformat(9, 8), qt.qformat(10, 8),"
        " qt.qformat(11, 8), qt.qformat(6, 4)))\n"
        "assert hy.shape == (3, 2)\n"
        "import torch.distributed as dist\n"
        "from qublas_tpu_torch import parallel as par\n"
        "assert par.init_distributed(backend='gloo') == 1\n"
        "mesh = par.make_mesh(1, 1, 'cpu')\n"
        "sa = qt.random_fill((4, 8), qt.qformat(3, 4), device='cpu')\n"
        "sb = qt.random_fill((8, 4), qt.qformat(3, 4), seed=5, device='cpu')\n"
        "sk = par.sharded_qgemul_k(sa, sb, qt.qformat(3, 4), mesh,"
        " mul_to=qt.qformat(20, 8), add_formats=(qt.qformat(20, 8),))\n"
        "sm = par.shard_qgemul(sa, sb, qt.qformat(3, 4), mesh,"
        " strategy='mn')\n"
        "assert sk.shape == sm.shape == (4, 4)\n"
        "dist.destroy_process_group()\n"
        "from qublas_tpu_torch import fuzz\n"
        "from qublas_tpu_torch.examples import asic_datapath_sim, "
        "sharded_deployment, wide_formats_and_sharding\n"
        "sw = fuzz.Sweep('cpu', echo=False)\n"
        "fuzz.sweep_k2(sw, 1)\n"
        "fuzz.sweep_cast(sw, 1)\n"
        "assert sw.fails == 0, sw.lines\n"
        "pw = [rng.randint(-128, 128, (32, 32)).astype(np.int8) for _ in"
        " range(3)]\n"
        "pipe = qt.QuantPipeline.from_numpy(pw[1], pw[2], 'cpu')\n"
        "cp = torch.compile(pipe, fullgraph=True, dynamic=False,"
        " backend='aot_eager')\n"
        "assert torch.equal(cp(torch.from_numpy(pw[0])),"
        " pipe(torch.from_numpy(pw[0])))\n"
        "cr = torch.compile(lambda t: qt.qreduce(qt.qmul(t, t), axis=1),"
        " fullgraph=True, dynamic=False, backend='aot_eager')\n"
        "assert cr(x).raw_list() == qt.qreduce(qt.qmul(x, x), axis=1)"
        ".raw_list()\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'qublas_tpu' or m.startswith('qublas_tpu.')]\n"
        "assert not bad, bad\n"
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
