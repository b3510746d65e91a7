"""The port's native host engine (``qublas_tpu_torch.native``) against the
port's exact Python model (``hostint``/``hostops``), Δ=0, as
``tests/test_native.py`` holds the JAX package's.

``hostops`` is pinned to the JAX package's by ``tests/test_torch_copies.py``
and through it to the compiled reference's goldens.  The engine is built
from ``native/*.cpp``/``*.c`` into ``build/qublas_tpu_torch/``, never beside
the sources.  Every mode pair runs through the 64-bit engine (requantize,
the four binary ops, the double constructor) and the multiword engine (the
same ops at 300 and 1,200 bits); the tree GEMM in both; bit packing.
"""

import itertools
import shutil
from pathlib import Path

import numpy as np
import pytest

from qublas_tpu_torch import _build, hostint, hostops, native
from qublas_tpu_torch.bitstream import elem_bits
from qublas_tpu_torch.qformat import (OverflowMode, QFormat, RoundMode,
                                      mul_merge, qformat)

MODES = list(itertools.product(RoundMode, OverflowMode))
MODE_IDS = [f"{r.name}-{o.name}" for r, o in MODES]
HOST_OPS = {"mul": hostops.qmul, "add": hostops.qadd, "sub": hostops.qsub,
            "div": hostops.qdiv}


def _sample(rng, fmt, n):
    return rng.randint(fmt.raw_min, fmt.raw_max + 1, size=n)


def _wide(rng, fmt, n):
    """``n`` raws over the whole range of a format of any width, its edges
    and zero first."""
    span = fmt.raw_max - fmt.raw_min + 1
    vals = [fmt.raw_min, fmt.raw_max, 0, -1, 1]
    while len(vals) < n:
        v = 0
        for _ in range(fmt.storage_bits // 62 + 2):
            v = (v << 62) | int(rng.randint(0, 1 << 62))
        vals.append(fmt.raw_min + v % span)
    return np.array(vals[:n], dtype=object)


def test_engine_builds_into_the_build_directory():
    """The libraries load from ``build/qublas_tpu_torch/``, named by a hash
    of their source, and nothing is written beside ``native/*``."""
    assert shutil.which("g++") is not None and native.available()
    lib = Path(native.get_lib()._name)
    assert lib.parent == _build.BUILD_DIR
    assert lib.name.startswith("libqublas_host_")
    fl = native.get_fastlimbs()
    assert fl is not None and Path(fl.__file__).parent == _build.BUILD_DIR


@pytest.mark.parametrize("rm,om", MODES, ids=MODE_IDS)
def test_requantize_every_mode(rm, om):
    rng = np.random.RandomState(int(rm) * 5 + int(om))
    src = qformat(6, 6)
    for dst in (qformat(3, 2, round_mode=rm, overflow_mode=om),
                qformat(8, 9, round_mode=rm, overflow_mode=om),
                qformat(2, 1, signed=False, round_mode=rm, overflow_mode=om)):
        raws = _sample(rng, src, 100)
        got = native.requantize(raws, src, dst)
        want = [hostint.requantize(int(v), src.frac_bits, dst) for v in raws]
        assert got is not None and got.tolist() == want, dst


@pytest.mark.parametrize("rm,om", MODES, ids=MODE_IDS)
def test_binary_ops_every_mode(rm, om):
    rng = np.random.RandomState(100 + int(rm) * 5 + int(om))
    fa, fb = qformat(4, 4), qformat(3, 5)
    to = qformat(3, 2, round_mode=rm, overflow_mode=om)
    for op, fn in HOST_OPS.items():
        a, b = _sample(rng, fa, 60), _sample(rng, fb, 60)
        if op == "div":
            b[b == 0] = 1
            b[7] = 0  # one divide by zero
        got = native.binary_op(op, a, b, fa, fb, to)
        want = [fn((int(x), fa), (int(y), fb), to=to)[0]
                for x, y in zip(a, b)]
        assert got is not None and got.tolist() == want, op


@pytest.mark.parametrize("rm,om", MODES, ids=MODE_IDS)
def test_multiword_ops_every_mode(rm, om):
    """300-bit operands on the multiword engine (a 601-bit product), and a
    1,200-bit product on its 2,048-bit width: every op, every mode."""
    rng = np.random.RandomState(200 + int(rm) * 5 + int(om))
    for fa, fb, to in ((qformat(200, 100), qformat(150, 49),
                        qformat(250, 120, round_mode=rm, overflow_mode=om)),
                       (qformat(600, 0), qformat(500, 99),
                        qformat(700, 90, round_mode=rm, overflow_mode=om))):
        a, b = _wide(rng, fa, 12), _wide(rng, fb, 12)
        for op, fn in HOST_OPS.items():
            got = native.binary_op(op, a, b, fa, fb, to)
            want = [fn((int(x), fa), (int(y), fb), to=to)[0]
                    for x, y in zip(a, b)]
            assert got is not None and [int(v) for v in got] == want, \
                (op, fa, to)
        got = native.requantize(a, fa, to)
        want = [hostint.requantize(int(v), fa.frac_bits, to) for v in a]
        assert got is not None and [int(v) for v in got] == want


@pytest.mark.parametrize("rm", list(RoundMode))
def test_double_to_raw_every_round_mode(rm):
    vals = [0.0, 1.0, -1.0, 1.25, -1.25, 0.1, -0.1, 3.14159, 1e-8, -1e-8,
            123456.789, -123456.789, 1e20, -1e20, 1e-300, 0.09375,
            float("nan"), float("inf"), float("-inf"), 255.9999, -256.0]
    for om in (OverflowMode.SAT_TCPL, OverflowMode.SAT_ZERO,
               OverflowMode.SAT_SMGN):
        for f in (qformat(8, 8, round_mode=rm, overflow_mode=om),
                  qformat(6, -3, round_mode=rm, overflow_mode=om),
                  qformat(3, 5, signed=False, round_mode=rm,
                          overflow_mode=om),
                  qformat(30, 30, round_mode=rm, overflow_mode=om)):
            got = native.double_to_raw(np.array(vals), f)
            want = [hostint.double_to_raw(v, f) for v in vals]
            assert got is not None and got.tolist() == want, f


def test_double_to_raw_refuses_wrap_modes_and_wide_formats():
    """Outside its envelope the engine returns None and the caller takes
    the Python model."""
    for om in (OverflowMode.WRP_TCPL, OverflowMode.WRP_TCPL_SAT):
        assert native.double_to_raw(np.array([1.0]),
                                    qformat(8, 8, overflow_mode=om)) is None
    assert native.double_to_raw(np.array([1.0]), qformat(40, 40)) is None


def test_shift_wide_matches_python():
    vals = np.array([(1 << 700) + 3, -(1 << 650) - 1, 5, -7, 0], dtype=object)
    for s in (0, 1, 63, 400, -1, -64, -700):
        got = native.shift_wide(vals, s)
        want = [v << s if s >= 0 else v >> -s for v in vals]
        assert got is not None and [int(v) for v in got] == want, s


def test_pack_unpack_bits():
    rng = np.random.RandomState(5)
    for f in (qformat(6, 3), qformat(30, 33)):
        raws = _sample(rng, f, 64)
        s = native.pack_bits(raws, f.width)
        assert s == "".join(elem_bits(int(v), f.width) for v in raws)
        if f.width < 64:
            assert native.unpack_bits(s, f.width, True).tolist() == \
                [int(v) for v in raws]
            assert native.unpack_bits(s, f.width, False).tolist() == \
                [int(v) & ((1 << f.width) - 1) for v in raws]


def _host_gemm(A, B, fa, fb, out, mul_to, layers, full=False):
    ar = [[(int(A[i, p]), fa) for p in range(A.shape[1])]
          for i in range(A.shape[0])]
    br = [[(int(B[p, j]), fb) for j in range(B.shape[1])]
          for p in range(B.shape[0])]
    return [[c[0] for c in row] for row in
            hostops.qgemul(ar, br, out, mul_to, layers, mul_full_prec=full)]


@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 13, 16, 33])
def test_tree_gemm_host_matches_hostops(k):
    rng = np.random.RandomState(k)
    fa, fb = qformat(4, 4), qformat(3, 5)
    mul_to = qformat(5, 5, overflow_mode=OverflowMode.SAT_ZERO)
    layers = (qformat(6, 4, round_mode=RoundMode.RND_CONV), qformat(5, 2))
    out = qformat(6, 3)
    A = rng.randint(fa.raw_min, fa.raw_max + 1, (3, k))
    B = rng.randint(fb.raw_min, fb.raw_max + 1, (k, 4))
    got = native.tree_gemm_host(A, B, fa, fb, mul_merge(fa, fb, mul_to),
                                layers, out)
    assert got is not None
    assert got.tolist() == _host_gemm(A, B, fa, fb, out, mul_to, layers)


def test_tree_gemm_host_multiword():
    """1,201-bit operands on the multiword engine's tree GEMM."""
    rng = np.random.RandomState(9)
    f = qformat(600, 600)
    A, B = _wide(rng, f, 6).reshape(2, 3), _wide(rng, f, 6).reshape(3, 2)
    layers = (qformat(601, 600, round_mode=RoundMode.RND_CONV),)
    got = native.tree_gemm_host(A, B, f, f, mul_merge(f, f), layers, f)
    assert got is not None
    assert [[int(v) for v in row] for row in got] == \
        _host_gemm(A, B, f, f, f, None, layers)


def test_value_widths_route_wart_raws_to_the_multiword_engine():
    """Raws beyond their format's storage (the fill(int) wart) are sized by
    their values, not their format: a lane format's 70-bit raws multiply on
    the multiword engine, exactly."""
    f = qformat(3, 4)
    a = np.array([(1 << 70) + 1, -5, 3], dtype=object)
    b = np.array([3, 1 << 40, -2], dtype=object)
    to = QFormat(120, 8)
    got = native.binary_op("mul", a, b, f, f, to)
    want = [hostops.qmul((int(x), f), (int(y), f), to=to)[0]
            for x, y in zip(a, b)]
    assert got is not None and [int(v) for v in got] == want
