"""The port's copy of ``tests/test_fuzz_differential.py``, lane formats:
random formats and modes (negative int and frac bits included) through
the elementwise ops, ``qreduce``, ``qgemul`` and ``qcast`` on the CPU (the
plain versions), each trial held bit for bit to the port's ``hostops`` and
to the JAX package on the same raws, formats compared field by field.
Same trial counts (``depthctl``) and seeds as the JAX file.
"""

import numpy as np
import pytest

import depthctl
from torch_fuzz_gen import Gen, flat, jfmt, jq, same_fmt

import qublas_tpu.ops.elementwise as jew
import qublas_tpu.ops.gemm as jgemm
import qublas_tpu.ops.reduce as jreduce
from qublas_tpu_torch import hostops
from qublas_tpu_torch.ops import elementwise as ew
from qublas_tpu_torch.ops.gemm import qgemul
from qublas_tpu_torch.ops.reduce import qreduce
from qublas_tpu_torch.qtensor import from_raw


def cpu(raws, fmt):
    return from_raw(raws, fmt, device="cpu")


@pytest.mark.parametrize("trial", range(depthctl.trials(60, 24)))
def test_fuzz_binary_ops(trial):
    g = Gen("test_fuzz_binary_ops", trial)
    fa, fb = g.fmt(), g.fmt()
    to = None if g.rng.randint(0, 2) else g.fmt()
    op = ["qmul", "qadd", "qsub", "qdiv"][g.rng.randint(0, 4)]
    n = 24
    a_raws, b_raws = g.raws(fa, n), g.raws(fb, n)
    if op == "qdiv":
        b_raws = np.array([v if v else 1 for v in b_raws], dtype=object)
        b_raws[3] = 0  # keep one div-by-zero
    dev = getattr(ew, op)(cpu(a_raws, fa), cpu(b_raws, fb), to=to)
    jax = getattr(jew, op)(jq(a_raws, fa), jq(b_raws, fb), to=jfmt(to))
    for x, y, got, j in zip(a_raws, b_raws, flat(dev), flat(jax)):
        want, wf = getattr(hostops, op)((int(x), fa), (int(y), fb), to=to)
        assert got == want == j, (op, fa, fb, to, int(x), int(y), got, j)
        assert dev.fmt == wf
    assert same_fmt(dev.fmt, jax.fmt)


@pytest.mark.parametrize("trial", range(depthctl.trials(20, 8)))
def test_fuzz_qreduce(trial):
    g = Gen("test_fuzz_qreduce", trial)
    fa = g.fmt(16)
    n = int(g.rng.randint(1, 20))
    nlayers = g.rng.randint(0, 3)
    layers = tuple(g.fmt(20) for _ in range(nlayers))
    raws = g.raws(fa, n)
    dev = qreduce(cpu(raws, fa), layers)
    jax = jreduce.qreduce(jq(raws, fa), tuple(jfmt(f) for f in layers))
    want, wf = hostops.qreduce_list([(int(v), fa) for v in raws], layers)
    assert flat(dev) == [want] == flat(jax), (fa, layers, n)
    assert dev.fmt == wf and same_fmt(dev.fmt, jax.fmt)


@pytest.mark.parametrize("trial", range(depthctl.trials(12, 6)))
def test_fuzz_qgemul(trial):
    g = Gen("test_fuzz_qgemul", trial)
    fa, fb = g.fmt(14), g.fmt(14)
    out = g.fmt(16)
    mul_to = None if g.rng.randint(0, 2) else g.fmt(20)
    nlayers = g.rng.randint(0, 3)
    layers = tuple(g.fmt(22) for _ in range(nlayers))
    m, k, n = (int(g.rng.randint(1, 5)) for _ in range(3))
    A = g.raws(fa, m * k).reshape(m, k)
    B = g.raws(fb, k * n).reshape(k, n)
    dev = qgemul(cpu(A, fa), cpu(B, fb), out, mul_to=mul_to,
                 add_formats=layers)
    jax = jgemm.qgemul(jq(A, fa), jq(B, fb), jfmt(out), mul_to=jfmt(mul_to),
                       add_formats=tuple(jfmt(f) for f in layers))
    ar = [[(int(A[i, p]), fa) for p in range(k)] for i in range(m)]
    br = [[(int(B[p, j]), fb) for j in range(n)] for p in range(k)]
    host = hostops.qgemul(ar, br, out, mul_to, layers)
    want = [host[i][j][0] for i in range(m) for j in range(n)]
    assert flat(dev) == want == flat(jax), (fa, fb, out, mul_to, layers,
                                            (m, k, n))
    assert same_fmt(dev.fmt, jax.fmt)


@pytest.mark.parametrize("trial", range(depthctl.trials(20, 8)))
def test_fuzz_qcast(trial):
    g = Gen("test_fuzz_qcast", trial)
    src, dst = g.fmt(40), g.fmt(40)
    raws = g.raws(src, 32)
    dev = ew.qcast(cpu(raws, src), dst)
    jax = jew.qcast(jq(raws, src), jfmt(dst))
    want = [hostops.convert((int(x), src), dst)[0] for x in raws]
    assert flat(dev) == want == flat(jax), (src, dst)
