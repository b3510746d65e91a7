"""The port's ANUS ``qpoly``/``Segment``/``qapprox``/``qtable`` against the
JAX package, Δ=0.

Mirrors ``tests/test_anus.py``: the Horner recursion with per-level
formats, the segment select (strictly-less breakpoints, a breakpoint below
every storable value, one above every value of an int8 lane, constant
segments broadcast to x's shape), the requantize into x's format, on lane,
pair and limb storage; and the one-shot ``qtable``.  The same raws, made
with numpy from a seed, go through both packages; raws and formats must be
equal (formats field by field, ``P`` carries them into the port).
"""

import dataclasses
import math

import numpy as np
import pytest

from qublas_tpu import anus as JA
from qublas_tpu import hostint, hostops
from qublas_tpu import qtensor as JQ
from qublas_tpu.qformat import OverflowMode, RoundMode, qformat
from qublas_tpu_torch import anus as TA
from qublas_tpu_torch import qtensor as TQ
from qublas_tpu_torch.convert import port_format as P

F48 = qformat(4, 8)


def _same(got, want):
    assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
    assert (got.is_pair, got.is_limb) == (want.is_pair, want.is_limb)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(np.asarray(got.raw(), dtype=object),
                                  np.asarray(want.raw(), dtype=object))


def _both(raws, fmt):
    raws = np.asarray(raws, dtype=object)
    return JQ.from_raw(raws, fmt), TQ.from_raw(raws, P(fmt), "cpu")


def _coeffs(raws_fmts):
    """Scalar coefficients from (raw, fmt) pairs, in both packages."""
    j, t = zip(*(_both(np.array(r, dtype=object), f) for r, f in raws_fmts))
    return list(j), list(t)


def host_qpoly(x_pair, coeff_pairs):
    """The reference's Horner recursion (QuBLAS.h:4836-4851) on hostops."""
    acc = coeff_pairs[-1]
    for a in reversed(coeff_pairs[:-1]):
        acc = hostops.qadd(a, hostops.qmul(x_pair, acc, to=a[1]), to=a[1])
    return acc


# x's format, the coefficients' formats and the x raws: one a storage kind
def _lane_case(rng):
    return F48, (F48, qformat(6, 6), qformat(3, 9)), \
        rng.randint(F48.raw_min, F48.raw_max + 1, 24)


def _pair_case(rng):
    f = qformat(31, 8)               # 40-bit pair storage
    xs = [int(v) << 8 for v in rng.randint(-(1 << 31), 1 << 31, 20)]
    return f, (qformat(20, 12), qformat(24, 12), qformat(18, 14)), \
        xs + [f.raw_min, f.raw_max, 0, -1]


def _limb_case(rng):
    f = qformat(80, 40)              # 121-bit storage: 4 limbs
    xs = [(int(v) << 57) + 12345 for v in rng.randint(-2**40, 2**40, 16)]
    return f, (qformat(90, 30),) * 3, xs + [f.raw_min, f.raw_max, 0, -1]


CASES = {"lane": _lane_case, "pair": _pair_case, "limb": _limb_case}
COEFF_RAWS = (3 << 5, -(5 << 3), 7 << 1)


@pytest.mark.parametrize("kind", list(CASES))
def test_qpoly_matches_jax_and_host(kind):
    fx, fcs, xs = CASES[kind](np.random.RandomState(11))
    jx, tx = _both(xs, fx)
    jc, tc = _coeffs(zip(COEFF_RAWS, fcs))
    got = TA.qpoly(tx, tc)
    _same(got, JA.qpoly(jx, jc))
    cpairs = [(r, f) for r, f in zip(COEFF_RAWS, fcs)]
    for i, xv in enumerate(xs):
        hr, hf = host_qpoly((int(xv), fx), cpairs)
        assert int(got.raw()[i]) == hr
        assert dataclasses.astuple(got.fmt) == dataclasses.astuple(hf)


def test_qpoly_scalar_coefficients_from_doubles():
    """``scalar`` coefficients, as tests/test_anus.py builds them."""
    rng = np.random.RandomState(3)
    xs = rng.randint(F48.raw_min, F48.raw_max + 1, 16)
    jx, tx = _both(xs, F48)
    vals = (0.5, -1.25, 0.75)
    got = TA.qpoly(tx, [TQ.scalar(v, P(F48), "cpu") for v in vals])
    _same(got, JA.qpoly(jx, [JQ.scalar(v, F48) for v in vals]))


def _segments(fcs, consts):
    """Four segments in both packages: a breakpoint below every storable
    value (never taken), a linear one at 0, a constant one at 1 (a 0-d
    result), and a quadratic tail."""
    jc, tc = _coeffs(zip(COEFF_RAWS, fcs))
    jk, tk = _coeffs([(consts, fcs[0])])
    bps = (-1e300, 0.0, 1.0, 2.0)
    polys_j = ([jc[0]], jc[:2], jk, jc)
    polys_t = ([tc[0]], tc[:2], tk, tc)
    return ([JA.Segment(b, c) for b, c in zip(bps, polys_j)],
            [TA.Segment(b, c) for b, c in zip(bps, polys_t)])


@pytest.mark.parametrize("kind", list(CASES))
def test_qapprox_matches_jax(kind):
    fx, fcs, xs = CASES[kind](np.random.RandomState(12))
    # values around every breakpoint: -1, 0, 1, 2 and their neighbours
    one = 1 << fx.frac_bits
    xs = list(xs) + [v * one + e for v in (-1, 0, 1, 2) for e in (-1, 0, 1)]
    jx, tx = _both(xs, fx)
    js, ts = _segments(fcs, 9 << 3)
    got = TA.qapprox(tx, ts)
    assert got.fmt == P(fx)
    _same(got, JA.qapprox(jx, js))


def test_qapprox_host_recursion_and_strict_breakpoint():
    """tests/test_anus.py's selection checks: the segment's polynomial
    requantized into x's format, and the raw at a breakpoint taking the
    next segment."""
    c = [TQ.scalar(v, P(F48), "cpu") for v in (1.0, 0.5, -1.0, 2.0)]
    segs = [TA.Segment(0.0, c[:2]), TA.Segment(1.0, c[2:])]
    xs = np.array([-1024, -512, -1, 0, 1, 255, 256, 511, 1023])
    dev = TA.qapprox(TQ.from_raw(xs, P(F48), "cpu"), segs)
    cp = [(int(t.raw()), F48) for t in c]
    for i, xv in enumerate(xs):
        val = hostint.raw_to_double(int(xv), F48)
        pair = host_qpoly((int(xv), F48), cp[:2] if val < 0.0 else cp[2:])
        assert int(dev.raw()[i]) == hostops.convert(pair, F48)[0]
    f = P(qformat(4, 2))
    segs = [TA.Segment(1.0, [TQ.scalar(1.0, f, "cpu")]),
            TA.Segment(10.0, [TQ.scalar(2.0, f, "cpu")])]
    vals = TA.qapprox(TQ.from_raw([3, 4, 5], f, "cpu"), segs).to_double()
    assert list(vals) == [1.0, 2.0, 2.0]


@pytest.mark.parametrize("fmt", [qformat(3, 4), qformat(7, 8),
                                 qformat(3, 4, signed=False)],
                         ids=["int8", "int16", "uint8"])
def test_qapprox_thresholds_beyond_the_lane(fmt):
    """Breakpoints above every storable value give thresholds beyond the
    int8/int16 lane (16,000 - 1 for 1000.0 at 4 fraction bits, the int32
    word's top raw for 1e12), and one below every value none: a select
    that compared the raw lanes with the Python int would wrap it and pick
    the wrong segment."""
    raws = np.arange(fmt.raw_min, fmt.raw_max + 1, 7)
    jx, tx = _both(raws, fmt)
    jc, tc = _coeffs([(r, fmt) for r in (5, -3, 9, 11)])
    bps = (-1e12, 1000.0, 1e12, 2e12)
    assert TA._raw_threshold(1000.0, P(fmt), 32) == \
        1000 * (1 << fmt.frac_bits) - 1
    assert TA._raw_threshold(1e12, P(fmt), 32) == (1 << 31) - 1
    assert TA._raw_threshold(-1e12, P(fmt), 32) is None
    # every x takes the second segment (coefficient -3) in both lists
    for bps in (bps, (-1e12, 1e12, 2e12)):
        got = TA.qapprox(tx, [TA.Segment(b, [c]) for b, c in zip(bps, tc)])
        _same(got, JA.qapprox(jx, [JA.Segment(b, [c])
                                   for b, c in zip(bps, jc)]))
        assert set(got.raw().tolist()) == {-3}


def test_raw_threshold_matches_jax():
    rng = np.random.RandomState(5)
    for fmt, word in ((F48, 32), (qformat(31, 8), 64),
                      (qformat(80, 40), 128), (qformat(3, 4, signed=False),
                                               32)):
        for bp in list(rng.uniform(-300, 300, 6)) + [0.0, 1e300, -1e300,
                                                      math.inf]:
            assert TA._raw_threshold(bp, P(fmt), word) == \
                JA._raw_threshold(bp, fmt, word)


def test_qtable_one_shot_matches_jax():
    f = qformat(3, 4)
    raws = np.arange(f.raw_min, f.raw_max + 1)
    jx, tx = _both(raws, f)
    outs = (None, qformat(1, 6, overflow_mode=OverflowMode.SAT_ZERO),
            qformat(20, 20), qformat(70, 30))     # lane, lane, pair, limb
    for func in (TA.rsqrt_func, TA.reciprocal_func, TA.sqrt_func):
        for out in outs:
            _same(TA.qtable(tx, func, P(out) if out else None),
                  JA.qtable(jx, func, out))


def test_qapprox_requantizes_with_x_modes():
    """A branch in a wider format requantizes with x's round and overflow
    modes (``decltype(x){...}``)."""
    fx = qformat(3, 4, round_mode=RoundMode.RND_CONV,
                 overflow_mode=OverflowMode.SAT_ZERO)
    fc = qformat(10, 10)
    raws = np.arange(fx.raw_min, fx.raw_max + 1)
    jx, tx = _both(raws, fx)
    jc, tc = _coeffs([(1 << 9, fc), (3 << 8, fc)])
    got = TA.qapprox(tx, [TA.Segment(0.5, tc)])
    _same(got, JA.qapprox(jx, [JA.Segment(0.5, jc)]))
