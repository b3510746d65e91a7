"""The port's raw-bitwise ops and decimal I/O (``qublas_tpu_torch.bitwise``)
against ``qublas_tpu.bitwise``, Δ=0.

Lane, pair and limb operands in every mix (the narrower sign-extends, the
result takes the wider storage's format, either operand order), ``qnot`` on
each kind (limbs stay 32-bit values), ``fill(int)`` wart raws held in a
wider lane (``tests/test_bitwise.py:113``), broadcasting, and the decimal
round trip with the machine-word wrap.  The same raws, made from numpy
seeds, go through both packages; Python ints are the oracle besides.
"""

import dataclasses
import operator

import numpy as np
import pytest

from qublas_tpu import bitwise as JB
from qublas_tpu import qtensor as JQ
from qublas_tpu.qformat import qformat
from qublas_tpu_torch import bitwise as TB
from qublas_tpu_torch import qtensor as TQ
from qublas_tpu_torch.convert import port_format as P

OPS = [("qand", operator.and_), ("qor", operator.or_),
       ("qxor", operator.xor)]

F_LANE8 = qformat(3, 4)          # int8 lanes
F_LANE16 = qformat(7, 8, signed=False)
F_LANE32 = qformat(15, 10)       # int32 lanes
F_PAIR = qformat(30, 9)          # 40-bit pair
F_PAIR64 = qformat(40, 23)       # 64-bit pair
F_LIMB = qformat(50, 29)         # 80-bit, 3 limbs
F_LIMB2 = qformat(150, 49)       # 200-bit, 7 limbs


def _same(got, want):
    assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
    assert (got.is_pair, got.is_limb) == (want.is_pair, want.is_limb)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(np.asarray(got.raw(), dtype=object),
                                  np.asarray(want.raw(), dtype=object))


def _rand(fmt, n, seed):
    """``n`` raws of ``fmt`` (its edges first) in both packages."""
    rng = np.random.RandomState(seed)
    edges = [fmt.raw_min, fmt.raw_max, 0, -1 if fmt.signed else 1]
    bits = fmt.storage_bits
    vals = []
    for _ in range(n - len(edges)):
        v = 0
        for _w in range(-(-bits // 31)):
            v = (v << 31) | int(rng.randint(0, 1 << 31))
        vals.append(fmt.raw_min + v % (fmt.raw_max - fmt.raw_min + 1))
    raws = np.array(edges + vals, dtype=object)
    return JQ.from_raw(raws, fmt), TQ.from_raw(raws, P(fmt), "cpu"), \
        [int(v) for v in raws]


MIXES = [(F_LANE8, F_LANE8), (F_LANE8, F_LANE16), (F_LANE16, F_LANE32),
         (F_LANE32, F_PAIR), (F_PAIR, F_PAIR64), (F_LANE8, F_LIMB),
         (F_PAIR, F_LIMB), (F_LIMB, F_LIMB2), (F_LANE32, F_LIMB2)]


@pytest.mark.parametrize("fa,fb", MIXES,
                         ids=[f"{a.storage_bits}x{b.storage_bits}"
                              for a, b in MIXES])
def test_bitwise_matches_jax(fa, fb):
    ja, ta, ra = _rand(fa, 16, 1)
    jb, tb, rb = _rand(fb, 16, 2)
    for name, op in OPS:
        for (x, y, jx, jy) in ((ta, tb, ja, jb), (tb, ta, jb, ja)):
            got = getattr(TB, name)(x, y)
            _same(got, getattr(JB, name)(jx, jy))
        assert got.raw_list() == [op(u, v) for u, v in zip(ra, rb)]


@pytest.mark.parametrize("fmt", [F_LANE8, F_LANE16, F_LANE32, F_PAIR,
                                 F_PAIR64, F_LIMB, F_LIMB2])
def test_qnot_matches_jax(fmt):
    ja, ta, ra = _rand(fmt, 12, 3)
    got = TB.qnot(ta)
    _same(got, JB.qnot(ja))
    assert got.raw_list() == [~v for v in ra]
    if got.is_limb:
        limbs = got.data.limbs
        assert int(limbs.min()) >= 0 and int(limbs.max()) <= 0xFFFFFFFF


def test_lane_wart_raws_not_truncated():
    """``fill(int)`` wart raws (beyond the format, in a wider lane) keep
    their bits through the lane route."""
    f = qformat(3, 4)
    raws, other = np.array([300, -200, 77]), np.array([0x1FF, 3, 5])
    ja, ta = JQ.from_raw(raws, f), TQ.from_raw(raws, P(f), "cpu")
    jb, tb = JQ.from_raw(other, f), TQ.from_raw(other, P(f), "cpu")
    _same(TB.qand(ta, ta), JB.qand(ja, ja))
    assert TB.qand(ta, ta).raw_list() == [300, -200, 77]
    _same(TB.qxor(ta, tb), JB.qxor(ja, jb))
    assert TB.qxor(ta, tb).raw_list() == [300 ^ 0x1FF, -200 ^ 3, 77 ^ 5]
    _same(TB.qnot(ta), JB.qnot(ja))


@pytest.mark.parametrize("fa,fb", [(F_LANE8, F_LANE32), (F_LANE32, F_PAIR),
                                   (F_PAIR, F_LIMB)])
def test_bitwise_broadcasts(fa, fb):
    """A row against a matrix: the broadcast shape, every kind."""
    ja, ta, ra = _rand(fa, 5, 4)
    jb, tb, rb = _rand(fb, 15, 5)
    got = TB.qor(ta, TQ.QTensor(tb.data.reshape(3, 5), tb.fmt))
    assert got.shape == (3, 5)
    assert got.raw_list() == [a | b for b, a in zip(rb, ra * 3)]


def test_decimal_roundtrip_and_word_wrap():
    for f in (F_LANE32, F_PAIR, F_LIMB):
        ja, ta, ra = _rand(f, 8, 6)
        dec = TB.to_decimal(ta)
        assert list(dec) == list(JB.to_decimal(ja))
        _same(TB.from_decimal(dec, P(f), "cpu"), JB.from_decimal(dec, f))
    f = F_LIMB                            # 80-bit storage, 128-bit word
    vals = ["123456789012345678901234", "-98765432109876543210", "0", "7"]
    t = TB.from_decimal(vals, P(f), "cpu")
    assert list(TB.to_decimal(t)) == vals
    # beyond the 128-bit machine word: wraps mod 2^128, signed
    for s, want in ((str((1 << 200) + 5), 5),
                    (str((1 << 127) + 1), -(1 << 127) + 1)):
        wide = qformat(80, 47)
        got = TB.from_decimal([s], P(wide), "cpu")
        _same(got, JB.from_decimal([s], wide))
        assert got.raw_list() == [want]
