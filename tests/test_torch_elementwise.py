"""The torch port's elementwise ops and QTensor constructors against the JAX
package, Δ=0 in raws, lane dtype and format fields.

Every lane route of the nine ops (``i32``; ``split`` for products wider
than int32; ``pair`` for 64-bit intermediates; ``host`` with a lane or
pair result) in every rounding x overflow mode, signed and unsigned, with
the reference warts (``SAT::ZERO`` overflow to zero, divide by zero -> 0,
truncation toward zero) and the int32 edges.  Configurations whose JAX
route is ``limb`` compute on the port's limb route; results that need host
storage (beyond 992 bits) raise ``NotImplementedError`` naming ROADMAP
A4b.  ``tests/test_torch_pair.py`` covers pair storage,
``tests/test_torch_limb.py`` limb storage.
"""

import dataclasses

import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu import qtensor as JQ
from qublas_tpu.ops import elementwise as JE
from qublas_tpu.qformat import OverflowMode, QFormat, RoundMode, qformat
from qublas_tpu.ops.widths import route_mul
from qublas_tpu_torch.convert import port_format as P
from qublas_tpu_torch.ops import elementwise as TE

MODES = [(rm, om, s) for rm in RoundMode for om in OverflowMode
         for s in (True, False)]
MODE_IDS = [f"{r.name}-{o.name}-{'s' if s else 'u'}" for r, o, s in MODES]


def _raws(rng, fmt, shape, zeros=False):
    """Random raws of the format's storage range, with its edges."""
    edges = [fmt.raw_min, fmt.raw_max, 0, 1, -1, fmt.raw_min + 1,
             fmt.raw_max - 1]
    edges = [e for e in edges if fmt.raw_min <= e <= fmt.raw_max]
    r = rng.randint(fmt.raw_min, fmt.raw_max + 1, size=int(np.prod(shape)),
                    dtype=np.int64)
    r[:len(edges)] = edges
    if zeros:
        r[::5] = 0
    return r.reshape(shape)


def _pair(rng, fa, fb, shape=(6, 7), zeros=False):
    """The same seeded raws as a JAX and a port QTensor."""
    a, b = _raws(rng, fa, shape), _raws(rng, fb, shape, zeros)
    return ((JQ.from_raw(a, fa), JQ.from_raw(b, fb)),
            (qt.from_raw(a, P(fa), "cpu"), qt.from_raw(b, P(fb), "cpu")))


def _same(got, want):
    if hasattr(want, "fmt"):
        assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
        assert got.is_limb == want.is_limb
        if got.is_limb:
            np.testing.assert_array_equal(got.raw(), want.raw())
            return
        got, want = got.data, want.raw()
    w = np.asarray(want)
    assert got.dtype == getattr(torch, str(w.dtype)), (got.dtype, w.dtype)
    np.testing.assert_array_equal(got.numpy(), w)


def _compare(name, jargs, targs, **kw):
    """One op on both sides, held Δ=0; True once compared (every device
    route is ported, the limb route included)."""
    want = getattr(JE, name)(*jargs, **kw)
    tkw = {k: P(v) if k == "to" and v is not None else v
           for k, v in kw.items()}
    _same(getattr(TE, name)(*targs, **tkw), want)
    return True


@pytest.mark.parametrize("rm,om,signed", MODES, ids=MODE_IDS)
def test_ops_match_jax(rm, om, signed):
    rng = np.random.RandomState(int(rm) * 20 + int(om) * 2 + int(signed))
    f = lambda i, fr: QFormat(i, fr, signed, rm, om)  # noqa: E731
    fa, fb, fc = f(3, 4), f(5, 2), f(8, 8)
    compared = 0
    (ja, jb), (ta, tb) = _pair(rng, fa, fb, zeros=True)
    for to in (None, f(2, 1), f(6, 3), f(12, 9)):
        for name in ("qmul", "qadd", "qsub", "qdiv"):
            compared += _compare(name, (ja, jb), (ta, tb), to=to)
    for name in ("qadd", "qsub", "qmul"):
        compared += _compare(name, (ja, jb), (ta, tb), full_prec=True)
    for name in ("qabs", "qneg"):
        compared += _compare(name, (ja,), (ta,))
        compared += _compare(name, (jb,), (tb,))
    for name in ("qcmp", "qeq"):
        compared += _compare(name, (ja, jb), (ta, tb))
        compared += _compare(name, (ja, ja), (ta, ta))
    for dst in (f(2, 2), f(4, 6), fa):
        compared += _compare("qcast", (jb, dst), (tb, P(dst)))
    # products wider than int32: the split route
    (jc, jd), (tc, td) = _pair(rng, fc, fc)
    assert route_mul(fc, fc, fc)[0] == \
        ("pair" if om == OverflowMode.WRP_TCPL_SAT else "split")
    for to in (None, f(6, 10)):
        compared += _compare("qmul", (jc, jd), (tc, td), to=to)
    # the divide's host route (negative output frac) with a lane result
    compared += _compare("qdiv", (ja, jb), (ta, tb), to=f(9, -1))
    assert compared == 33


@pytest.mark.parametrize("name,fmt", [
    ("qadd", qformat(29, 0)), ("qsub", qformat(29, 0)),
    ("qneg", qformat(30, 0)), ("qabs", qformat(30, 0)),
    ("qcmp", qformat(31, 0)), ("qeq", qformat(31, 0)),
    ("qmul", qformat(15, 0)), ("qdiv", qformat(14, 8)),
    ("qneg", qformat(3, 4, overflow_mode=OverflowMode.WRP_TCPL_SAT)),
], ids=["qadd", "qsub", "qneg", "qabs", "qcmp", "qeq", "qmul", "qdiv",
        "qneg-word"])
def test_int32_edges(name, fmt):
    """Raws at the storage edges of formats that fill the int32 lane."""
    rng = np.random.RandomState(len(name))
    (ja, jb), (ta, tb) = _pair(rng, fmt, fmt, shape=(40,), zeros=True)
    if fmt.overflow_mode == OverflowMode.WRP_TCPL_SAT:
        # the word-wrap stub holds any int32 raw but INT32_MIN, whose
        # negation needs host object storage (ROADMAP item 11)
        r = np.array([-(1 << 31) + 1, (1 << 31) - 1, 5, -7])
        ja, ta = JQ.from_raw(r, fmt), qt.from_raw(r, P(fmt), "cpu")
    args = ((ja,), (ta,)) if name in ("qneg", "qabs") else \
        ((ja, jb), (ta, tb))
    assert _compare(name, *args)


def test_unported_routes_raise():
    """The pair route computes (``tests/test_torch_pair.py`` holds it to
    the JAX package), and so do the routes that raised before limb storage
    was ported: the limb route and limb results, Δ=0 against the JAX
    package.  Results that need host storage still raise."""
    f = qformat(15, 16)  # 32-bit storage: products need the pair route
    (ja, jb), (ta, tb) = _pair(np.random.RandomState(1), f, f)
    assert _compare("qmul", (ja, jb), (ta, tb))
    assert _compare("qadd", (ja, jb), (ta, tb), to=qformat(40, 0))
    w = qformat(40, 0)       # 41-bit pair storage: 82-bit products
    jt, tt = JQ.from_raw(np.array([1, 2]), w), qt.from_raw([1, 2], P(w), "cpu")
    assert route_mul(w, w, w)[0] == "limb"
    assert _compare("qmul", (jt, jt), (tt, tt))
    assert _compare("qadd", (ja, jb), (ta, tb), to=qformat(70, 0))
    f70 = qformat(70, 0)
    assert _compare("qneg", (JQ.from_raw(np.array([1, -2]), f70),),
                    (qt.from_raw([1, -2], P(f70), "cpu"),))
    big = qt.from_raw([1, 2], P(qformat(900, 0)), "cpu")
    assert big.is_limb
    with pytest.raises(NotImplementedError, match="ROADMAP A4b"):
        qt.qmul(big, big, full_prec=True)


def test_operators_and_scalar_coercion_match_jax():
    rng = np.random.RandomState(3)
    fa = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
    fb = qformat(4, 6, round_mode=RoundMode.RND_CONV)
    (ja, jb), (ta, tb) = _pair(rng, fa, fb, zeros=True)
    _same(ta * tb, ja * jb)
    _same(ta + tb, ja + jb)
    _same(ta - tb, ja - jb)
    _same(ta / tb, ja / jb)
    _same(-ta, -ja)
    _same(abs(tb), abs(jb))
    _same(ta * 2.5, ja * 2.5)
    _same(qt.qadd(1.75, tb), JE.qadd(1.75, jb))
    assert ta.size == 42 and (ta * tb).device == torch.device("cpu")


@pytest.mark.parametrize("rm,om,signed", MODES, ids=MODE_IDS)
def test_constructors_match_jax(rm, om, signed):
    rng = np.random.RandomState(int(rm) * 20 + int(om) * 2 + int(signed))
    vals = np.concatenate([
        rng.standard_normal(30) * 9, [0.0, -0.0, 0.5, -0.5, 1.5, -2.5,
                                      0.03125, 1e9, -1e9, np.nan, np.inf]])
    for fmt in (QFormat(3, 4, signed, rm, om), QFormat(6, -2, signed, rm, om),
                QFormat(12, 10, signed, rm, om)):
        _same(qt.from_float(vals.reshape(41, 1), P(fmt), "cpu"),
              JQ.from_float(vals.reshape(41, 1), fmt))
        _same(qt.from_double(-3.3, P(fmt), "cpu"),
              JQ.from_double(-3.3, fmt))
        _same(qt.scalar(1.25, P(fmt), "cpu"), JQ.scalar(1.25, fmt))
        _same(qt.zeros((2, 3), P(fmt), "cpu"), JQ.zeros((2, 3), fmt))
        _same(qt.random_fill((4, 5), P(fmt), seed=9, device="cpu"),
              JQ.random_fill((4, 5), fmt, seed=9))
