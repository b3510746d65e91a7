"""The port's copy of ``tests/test_fuzz_differential.py``, wide formats:
33..64-bit storage (the port's pair storage, one int64 a value) mixed with
lane formats through the elementwise ops, ``qreduce`` and ``qcast`` on the
CPU, each trial held bit for bit to the port's ``hostops`` and to the JAX
package on the same raws, formats compared field by field.  Same trial
counts (``depthctl``) and seeds as the JAX file.
"""

import numpy as np
import pytest

import depthctl
from torch_fuzz_gen import Gen, flat, jfmt, jq, same_fmt

import qublas_tpu.ops.elementwise as jew
import qublas_tpu.ops.reduce as jreduce
from qublas_tpu_torch import hostops
from qublas_tpu_torch.ops import elementwise as ew
from qublas_tpu_torch.ops.reduce import qreduce
from qublas_tpu_torch.qtensor import from_raw


def cpu(raws, fmt):
    return from_raw(raws, fmt, device="cpu")


@pytest.mark.parametrize("trial", range(depthctl.trials(40, 16)))
def test_fuzz_wide_binary_ops(trial):
    g = Gen("test_fuzz_wide_binary_ops", trial)
    fa = g.wide_fmt()
    fb = g.wide_fmt() if g.rng.randint(0, 2) else g.fmt()
    if g.rng.randint(0, 2):
        fa, fb = fb, fa
    to = None if g.rng.randint(0, 3) == 0 else (
        g.wide_fmt() if g.rng.randint(0, 2) else g.fmt())
    op = ["qmul", "qadd", "qsub", "qdiv"][g.rng.randint(0, 4)]
    n = 16
    a_raws, b_raws = g.raws(fa, n), g.raws(fb, n)
    if op == "qdiv":
        b_raws = np.array([v if v else 1 for v in b_raws], dtype=object)
    dev = getattr(ew, op)(cpu(a_raws, fa), cpu(b_raws, fb), to=to)
    jax = getattr(jew, op)(jq(a_raws, fa), jq(b_raws, fb), to=jfmt(to))
    for x, y, got, j in zip(a_raws, b_raws, flat(dev), flat(jax)):
        want, wf = getattr(hostops, op)((int(x), fa), (int(y), fb), to=to)
        assert got == want == j, (op, fa, fb, to, int(x), int(y), got, j)
        assert dev.fmt == wf
    assert same_fmt(dev.fmt, jax.fmt)


@pytest.mark.parametrize("trial", range(depthctl.trials(12, 5)))
def test_fuzz_wide_qreduce(trial):
    g = Gen("test_fuzz_wide_qreduce", trial)
    fa = g.wide_fmt()
    n = int(g.rng.randint(1, 16))
    nlayers = g.rng.randint(0, 3)
    layers = tuple((g.wide_fmt() if g.rng.randint(0, 2) else g.fmt())
                   for _ in range(nlayers))
    raws = g.raws(fa, n)
    dev = qreduce(cpu(raws, fa), layers)
    jax = jreduce.qreduce(jq(raws, fa), tuple(jfmt(f) for f in layers))
    want, wf = hostops.qreduce_list([(int(v), fa) for v in raws], layers)
    assert flat(dev) == [want] == flat(jax), (fa, layers, n)
    assert dev.fmt == wf and same_fmt(dev.fmt, jax.fmt)


@pytest.mark.parametrize("trial", range(depthctl.trials(8, 4)))
def test_fuzz_wide_qcast(trial):
    g = Gen("test_fuzz_wide_qcast", trial)
    fa = g.wide_fmt()
    to = g.wide_fmt() if g.rng.randint(0, 2) else g.fmt()
    raws = g.raws(fa, 24)
    dev = ew.qcast(cpu(raws, fa), to)
    jax = jew.qcast(jq(raws, fa), jfmt(to))
    want = [hostops.convert((int(x), fa), to)[0] for x in raws]
    assert flat(dev) == want == flat(jax), (fa, to)


def test_wide_formats_are_device_resident():
    """33..64-bit-storage tensors live in device storage (one int64 a
    value), not in host object arrays, as the JAX package's live in limb
    pairs."""
    for trial in range(20):
        g = Gen("test_wide_formats_are_device_resident", trial)
        fa = g.wide_fmt()
        raws = g.raws(fa, 8)
        t = cpu(raws, fa)
        assert t.is_pair and not t.is_host, fa
        assert jq(raws, fa).is_pair
