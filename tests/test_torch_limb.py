"""The port's limb storage against the JAX package, Δ=0.

Formats of 65..992 storage bits are stacked 32-bit limbs in int64 tensors
(``qublas_tpu_torch.ops.limbint``), with the JAX package's limb counts.  The
same raws, made with numpy from a seed, go through both packages: every
``limbint`` op and ``requantize_limb`` in all 7 x 5 modes (edge raws:
limbs of ``0xFFFFFFFF``, the format's minimum and maximum, -1),
``ldiv_trunc``, the balanced-digit dot of ``limbdot``, the limb QTensor
(its BitStream round trip included),
the elementwise limb routes on the configurations of
``tests/test_limb384.py`` and ``tests/test_limb992.py``, ``qreduce`` and
``QTable`` into limb formats, ``qgemul``'s limb tier and its streaming tier
in limb values (each tier held on its own with ``force_tiers_off``, and
the port taking the JAX package's tier), and ``cgemul``'s limb domain with
the same ``info["domain"]``.  Raws and formats must be equal.
"""

import dataclasses
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu import bitstream as JB
from qublas_tpu import qtensor as JQ
from qublas_tpu.anus import QTable as JTable
from qublas_tpu.ops import cgemm as JCG
from qublas_tpu.ops import elementwise as JE
from qublas_tpu.ops import gemm as JG
from qublas_tpu.ops import limbdot as JD
from qublas_tpu.ops import limbint as JL
from qublas_tpu.ops.reduce import qreduce as jqreduce
from qublas_tpu.ops.widths import fmt_interval, route_div, route_mul
from qublas_tpu.qformat import (OverflowMode, QFormat, RoundMode, add_merge,
                                qformat)
from qublas_tpu_torch.convert import complex_from_jax, from_jax
from qublas_tpu_torch.convert import port_format as P
from qublas_tpu_torch.ops import cgemm as TCG
from qublas_tpu_torch.ops import gemm as TG
from qublas_tpu_torch.ops import limbdot as TD
from qublas_tpu_torch.ops import limbint as TL
from qublas_tpu_torch.ops.widths import Interval as TInterval

MODES = [(rm, om) for rm in RoundMode for om in OverflowMode]
MODE_IDS = [f"{r.name}-{o.name}" for r, o in MODES]
M32 = 0xFFFFFFFF


def _ints(rng, n, bits):
    """``n`` signed values of ``bits`` bits: the edges (0, +-1, the
    extremes, all-ones limbs, a single limb of ``0xFFFFFFFF``) that fit,
    then seeded values of every magnitude."""
    top = 1 << (bits - 1)
    edges = [0, 1, -1, -top, top - 1, M32, -M32, top - 1 - M32, -(1 << 32)]
    vals = [e for e in edges if -top <= e < top][:n]
    while len(vals) < n:
        nb = int(rng.randint(1, bits + 1))
        v = 0
        for _w in range(nb // 32 + 1):
            v = (v << 32) | int(rng.randint(0, 1 << 32, dtype=np.int64))
        v &= (1 << nb) - 1
        vals.append(v - (1 << (nb - 1)) if rng.randint(2) else v >> 1)
    return np.array(vals, dtype=object)


def _same_limbs(j, t):
    """JAX uint32 limbs equal the port's int64 limbs."""
    j = np.asarray(j).astype(np.int64)
    assert j.shape == tuple(t.shape)
    np.testing.assert_array_equal(j, t.cpu().numpy())


def _same(got, want):
    """A port QTensor (or compare tensor) equals the JAX package's: format
    fields, storage kind and raws."""
    if not hasattr(want, "fmt"):
        np.testing.assert_array_equal(got.cpu().numpy(), np.asarray(want))
        return
    assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
    assert (got.is_limb, got.is_pair, got.is_host) == \
        (want.is_limb, want.is_pair, want.is_host)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(
        np.asarray(got.raw(), dtype=object),
        np.asarray(want.raw(), dtype=object))


def _P(formats):
    return tuple(P(f) for f in formats)


def _both(raws, fmt):
    return JQ.from_raw(raws, fmt), qt.from_raw(raws, P(fmt), "cpu")


def _fill(fmt, shape, seed):
    j = JQ.random_fill(shape, fmt, seed)
    return j, from_jax(j, "cpu")


# ---------------------------------------------------------------------------
# limbint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 3, 5])
def test_limbint_ops_match_jax(K):
    rng = np.random.RandomState(K)
    a, b = _ints(rng, 40, 32 * K), _ints(rng, 40, 32 * K)
    ja, jb = JL.limbs_from_ints(a, K), JL.limbs_from_ints(b, K)
    ta, tb = TL.limbs_from_ints(a, K), TL.limbs_from_ints(b, K)
    _same_limbs(ja, ta)
    assert list(TL.ints_from_limbs(ta)) == [int(v) for v in a]
    for name in ("ladd", "lsub", "lltu", "llt", "leq"):
        for x, y, u, v in ((ja, jb, ta, tb), (ja, ja, ta, ta)):
            _same_limbs(getattr(JL, name)(x, y), getattr(TL, name)(u, v))
    for name in ("lneg", "lis_neg", "lis_pos", "lto_i32"):
        _same_limbs(getattr(JL, name)(ja), getattr(TL, name)(ta))
    for d in sorted({0, 1, 7, 31, 32, 33, 32 * K - 1}):
        _same_limbs(JL.lshl(ja, d), TL.lshl(ta, d))
        _same_limbs(JL.lshr(ja, d), TL.lshr(ta, d))
        _same_limbs(JL.llow_bits(ja, d), TL.llow_bits(ta, d))
    for k2 in sorted({1, K, K + 2, 2 * K}):
        _same_limbs(JL.lext(ja, k2), TL.lext(ta, k2))
        _same_limbs(JL.lmul(ja, jb, k2), TL.lmul(ta, tb, k2))
    cond = np.array(JL.llt(ja, jb))
    _same_limbs(JL.lselect(cond, ja, jb),
                TL.lselect(torch.from_numpy(cond), ta, tb))
    for c in (0, -1, 5, -(1 << (32 * K - 1)), 1 << 40):
        _same_limbs(JL.lconst(c, K, (2, 3)), TL.lconst(c, K, (2, 3)))
    _same_limbs(JL.lbroadcast_elem(ja[:, :4].reshape(K, 4, 1), (3, 4, 5)),
                TL.lbroadcast_elem(ta[:, :4].reshape(K, 4, 1), (3, 4, 5)))
    # the pair word: lto_i64 against the JAX package's (hi, lo) store
    hi, lo = JL.store_limbs(ja, qformat(40, 0))
    want = (np.asarray(hi).astype(np.int64) << 32) | np.asarray(lo).astype(
        np.int64)
    np.testing.assert_array_equal(TL.lto_i64(ta).numpy(), want)


def test_ldiv_trunc_matches_jax():
    rng = np.random.RandomState(3)
    K = 3
    num = _ints(rng, 30, 90)
    den = _ints(rng, len(num), 60)
    den[::7] = 0
    den[1], num[1] = -1, -(1 << 89)
    jn, jd = JL.limbs_from_ints(num, K), JL.limbs_from_ints(den, K)
    tn, td = TL.limbs_from_ints(num, K), TL.limbs_from_ints(den, K)
    for nbits in (1, 33, 91):
        _same_limbs(JL.ldiv_trunc(jn, jd, nbits),
                    TL.ldiv_trunc(tn, td, nbits))


@pytest.mark.parametrize("rm,om", MODES, ids=MODE_IDS)
def test_requantize_limb_matches_jax(rm, om):
    """Every destination storage kind, shifts in both directions, signed
    and unsigned."""
    rng = np.random.RandomState(int(rm) * 5 + int(om))
    K = 5
    x = _ints(rng, 30, 32 * K - 8)
    jx, tx = JL.limbs_from_ints(x, K), TL.limbs_from_ints(x, K)
    for ib, fb in ((20, 8), (40, 12), (90, 30)):
        for signed in (True, False):
            f = QFormat(ib, fb, signed, rm, om)
            for from_frac in (0, fb + 1, fb + 37):
                j = JL.requantize_limb(jx, from_frac, f)
                t = TL.requantize_limb(tx, from_frac, P(f))
                if isinstance(j, tuple):      # the JAX (hi, lo) pair
                    j = (np.asarray(j[0]).astype(np.int64) << 32) | \
                        np.asarray(j[1]).astype(np.int64)
                _same_limbs(j, t)


# ---------------------------------------------------------------------------
# limbdot
# ---------------------------------------------------------------------------

def test_limbdot_matches_jax():
    rng = np.random.RandomState(5)
    for fa in (qformat(5, 8), qformat(31, 8), qformat(70, 10)):
        j, t = _fill(fa, (3, 9), 7)
        iv = fmt_interval(fa)
        nd = JD.digits_needed(iv)
        _same_limbs(JD.balanced_digits(j.data, nd),
                    TD.balanced_digits(t.data, nd))
    v = np.array([0, -1, (1 << 31) - 1, -(1 << 31), 77], dtype=np.int32)
    _same_limbs(JD.i32_to_limbs(v, 3), TD.i32_to_limbs(torch.from_numpy(v),
                                                        3))
    limbs = _ints(rng, 24, 90).reshape(2, 3, 4)
    jl, tl = JL.limbs_from_ints(limbs, 4), TL.limbs_from_ints(limbs, 4)
    for axis in (0, -1):
        _same_limbs(JD.limb_axis_sum(jl, axis), TD.limb_axis_sum(tl, axis))
    # lanes against limbs (pair operands: the qgemul tests below)
    fa, fb = qformat(5, 8), qformat(70, 10)
    (ja, ta), (jb, tb) = _fill(fa, (3, 40), 8), _fill(fb, (40, 2), 9)
    iva, ivb = fmt_interval(fa), fmt_interval(fb)
    tiva, tivb = (TInterval(v.lo, v.hi) for v in (iva, ivb))
    assert TD.work_bits(tiva, tivb, 40) == JD.work_bits(iva, ivb, 40)
    Kw = TL.bits_to_limbs(TD.work_bits(tiva, tivb, 40))
    _same_limbs(JD.limb_dot_2d(ja.data, jb.data, iva, ivb, Kw),
                TD.limb_dot_2d(ta.data, tb.data, tiva, tivb, Kw))
    # 300-bit operands at k = 3400 take two k-segments (seg = 3,360 at 39
    # digits): against the exact Python-int dot
    f = qformat(299, 0)
    a, b = _fill(f, (1, 3400), 10)[1], _fill(f, (3400, 2), 11)[1]
    iv = TInterval(f.raw_min, f.raw_max)
    Kw = TL.bits_to_limbs(TD.work_bits(iv, iv, 3400))
    got = TL.ints_from_limbs(TD.limb_dot_2d(a.data, b.data, iv, iv, Kw))
    A, B = a.raw(), b.raw()
    for j in range(2):
        assert got[0, j] == sum(int(x) * int(y)
                                for x, y in zip(A[0], B[:, j]))
    assert TD._seg_len(3400, 39) < 3400


# ---------------------------------------------------------------------------
# QTensor
# ---------------------------------------------------------------------------

def test_limb_qtensor_matches_jax():
    for f in (qformat(70, 10), qformat(250, 133), qformat(600, 391),
              qformat(80, 0, overflow_mode=OverflowMode.WRP_TCPL_SAT)):
        j, t = _fill(f, (3, 4), 11)
        assert t.is_limb and t.data.nlimbs == j.data.nlimbs
        assert t.shape == (3, 4) and t.ndim == 2 and t.size == 12
        _same(t, j)
        _same(t[1:, ::2], JQ.QTensor(j.data[1:, ::2], f))
        _same(t[2], JQ.QTensor(j.data[2], f))
        _same(qt.zeros((2, 5), P(f), "cpu"), JQ.zeros((2, 5), f))
        np.testing.assert_array_equal(t.to_double(), j.to_double())
        raws = np.asarray(j.raw(), dtype=object)
        _same(qt.from_raw(raws, P(f), "cpu"), JQ.from_raw(raws, f))
        vals = np.array([0.0, -1.5, 3.25, 1e30, -2.0 ** 70, np.nan, 1e-9])
        _same(qt.from_float(vals, P(f), "cpu"), JQ.from_float(vals, f))
        _same(t.astype(P(qformat(20, 5))), j.astype(qformat(20, 5)))
        bits = JB.to_bits(j)
        assert qt.bitstream.to_bits(t) == bits
        _same(qt.bitstream.from_bits(bits, P(f), (3, 4),
                                     twos_complement=True, device="cpu"),
              JB.from_bits(bits, f, (3, 4), twos_complement=True))
    # raws beyond the limb word take host storage, as in the JAX package
    _same(qt.from_raw(np.array([1 << 100], dtype=object), P(qformat(70, 0)),
                      "cpu"),
          JQ.from_raw(np.array([1 << 100], dtype=object), qformat(70, 0)))
    with pytest.raises(TypeError, match="LimbArray"):
        qt.QTensor(TL.LimbArray(torch.zeros(2, 3, dtype=torch.int64)),
                   P(qformat(70, 0)))


# ---------------------------------------------------------------------------
# elementwise, qreduce, QTable
# ---------------------------------------------------------------------------

def _op(name, jargs, targs, **kw):
    want = getattr(JE, name)(*jargs, **kw)
    tkw = {k: P(v) if k == "to" and v is not None else v
           for k, v in kw.items()}
    _same(getattr(qt, name)(*targs, **tkw), want)


F301 = qformat(200, 100)        # tests/test_limb384.py
F384 = qformat(250, 133)
F512 = qformat(312, 199)        # tests/test_limb992.py
F992 = qformat(600, 391)


@pytest.mark.parametrize("rm,om", [
    pytest.param(*m, marks=() if i % 7 == 0 else pytest.mark.slow)
    for i, m in enumerate(MODES)], ids=MODE_IDS)
def test_limb_routes_match_jax_384(rm, om):
    """``tests/test_limb384.py``'s formats, limb operands against narrow
    ones, results in limb, pair and lane storage; five of the 35 mode
    pairs (every rounding and every overflow mode once) run by default,
    the rest behind ``slow``."""
    rng = np.random.RandomState(int(rm) * 5 + int(om))
    g = lambda i, f, s=True: QFormat(i, f, s, rm, om)  # noqa: E731
    ja, ta = _both(_ints(rng, 10, F301.storage_bits), F301)
    jb, tb = _both(_ints(rng, 10, 30), g(20, 9))
    jc, tc = _both(_ints(rng, 10, F384.storage_bits), F384)
    jb.raw()  # the narrow operand holds zeros too (divide by zero -> 0)
    for to in (None, g(260, 120), g(40, 10), g(12, 4, False)):
        for name in ("qmul", "qadd", "qsub"):
            _op(name, (ja, jb), (ta, tb), to=to)
        _op("qadd", (jc, ja), (tc, ta), to=to)
    _op("qdiv", (jb, ja), (tb, ta), to=g(40, 20))
    for x, y in ((ja, ta), (jc, tc)):
        _op("qabs", (x,), (y,))
        _op("qneg", (x,), (y,))
    _op("qcmp", (ja, jc), (ta, tc))
    _op("qcmp", (jb, ja), (tb, ta))
    _op("qeq", (ja, ja), (ta, ta))
    for dst in (g(5, 3), g(30, 20), g(100, 60), F384):
        _op("qcast", (ja, dst), (ta, P(dst)))
    _op("qcast", (jb, g(300, 80)), (tb, P(g(300, 80))))


def test_limb_routes_match_jax_992():
    """``tests/test_limb992.py``'s configurations: a 512-bit add on limbs,
    512 x narrow and 512 x 512 products, a 992 x 512 product on the host
    route into limb storage, casts out of and into 992-bit storage in every overflow
    mode; a result that needs host storage raises."""
    rng = np.random.RandomState(9)
    ja, ta = _both(_ints(rng, 6, 512), F512)
    jb, tb = _both(_ints(rng, 6, 512), F512)
    jn, tn = _both(_ints(rng, 6, 15), qformat(10, 4))
    _op("qadd", (ja, jb), (ta, tb), to=qformat(
        320, 199, round_mode=RoundMode.RND_CONV,
        overflow_mode=OverflowMode.SAT_ZERO))
    narrow_out = qformat(330, 203, overflow_mode=OverflowMode.SAT_TCPL)
    assert route_mul(F512, qformat(10, 4), narrow_out)[0] == "limb"
    _op("qmul", (ja, jn), (ta, tn), to=narrow_out)
    # the 512 x 512 product fills the 1,024-bit working envelope; into
    # 1,039-bit storage it needs host storage
    assert route_mul(F512, F512, qformat(300, 199))[0] == "limb"
    _op("qmul", (ja, jb), (ta, tb), to=qformat(300, 199))
    _op("qmul", (ja, jb), (ta, tb), to=qformat(640, 398))
    jw, tw = _both(_ints(rng, 6, 992), F992)
    # 992 x 512 bits outgrows it: the host route, into limb storage
    assert route_mul(F992, F512, qformat(300, 199))[0] == "host"
    _op("qmul", (jw, ja), (tw, ta), to=qformat(300, 199))
    for om in OverflowMode:
        dst = qformat(400, 200, round_mode=RoundMode.RND_CONV,
                      overflow_mode=om)
        _op("qcast", (jw, dst), (tw, P(dst)))
    up = qformat(600, 391, overflow_mode=OverflowMode.SAT_TCPL)
    _op("qcast", (jn, up), (tn, P(up)))
    _op("qneg", (ja,), (ta,))
    _op("qabs", (jb,), (tb,))
    _op("qcmp", (jw, jn), (tw, tn))


def test_limb_division_matches_jax():
    """The bit-serial limb divider (``tests/test_limb_div.py``'s routes):
    limb operands, mixed kinds, zero divisors, every overflow mode."""
    rng = np.random.RandomState(13)
    fa, fb = qformat(90, 20), qformat(40, 10)
    num = _ints(rng, 8, fa.storage_bits)
    den = _ints(rng, len(num), fb.storage_bits)
    den[::3] = 0
    (ja, ta), (jb, tb) = _both(num, fa), _both(den, fb)
    for om in OverflowMode:
        to = qformat(80, 30, overflow_mode=om)
        assert route_div(fa, fb, add_merge(fa, fb, to))[0] == "limb"
        _op("qdiv", (ja, jb), (ta, tb), to=to)
    jl, tl = _both(_ints(rng, len(num), 20), qformat(12, 7))
    _op("qdiv", (jl, jb), (tl, tb), to=qformat(70, 12))


def test_qreduce_and_qtable_into_limb_formats():
    rng = np.random.RandomState(17)
    # 510-bit values on limbs (tests/test_limb992.py), odd tails included
    fa = qformat(310, 199)
    jx, tx = _both(_ints(rng, 9, fa.storage_bits), fa)
    layers = (qformat(320, 199),)
    _same(qt.qreduce(tx, _P(layers)), jqreduce(jx, layers))
    # pair values summed into limb layers, and limb values into a pair
    fp = qformat(40, 20)
    jp, tp = _fill(fp, (5, 3), 19)
    layers = (qformat(70, 20), qformat(90, 30, round_mode=RoundMode.RND_CONV))
    _same(qt.qreduce(tp, _P(layers), axis=0), jqreduce(jp, layers, axis=0))
    # a ROM into limb storage
    fin = qformat(3, 4)
    raws = np.arange(-128, 128).reshape(16, 16)
    for out in (qformat(90, 40), qformat(70, 60, False)):
        jt, tt = JTable(np.sqrt, fin, out), qt.QTable(np.sqrt, P(fin),
                                                      P(out))
        j, t = _both(raws, fin)
        _same(tt(t), jt(j))


# ---------------------------------------------------------------------------
# qgemul's limb tier and streaming tier; cgemul's limb domain
# ---------------------------------------------------------------------------

_TIERS = ("_fast_gemm_limb", "_fast_gemm_wide", "_stream_gemm_wide")


@contextmanager
def _tier_taken(mod, monkeypatch):
    """Records which lossless-wide or streaming tier of ``mod`` produced
    the result (None: none of them)."""
    seen = []
    for name in _TIERS:
        fn = getattr(mod, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            res = _fn(*args, **kw)
            if res is not None:
                seen.append(_name)
            return res

        monkeypatch.setattr(mod, name, spy)
    yield seen
    monkeypatch.undo()


def _gemm_both(monkeypatch, ja, jb, ta, tb, out, **kw):
    tkw = {k: (P(v) if isinstance(v, QFormat) else
               tuple(P(x) for x in v) if k == "add_formats" else v)
           for k, v in kw.items()}
    with _tier_taken(JG, monkeypatch) as jt:
        want = JG.qgemul(ja, jb, out, **kw)
    with _tier_taken(TG, monkeypatch) as tt:
        got = TG.qgemul(ta, tb, P(out), **tkw)
    _same(got, want)
    assert jt == tt, (jt, tt)
    return tt


GEMMS = {
    # 40-bit pair operands, 80-bit products (chip_smoke.py path g1)
    "g1": (qformat(31, 8), dict(mul_to=qformat(63, 16),
                                add_formats=(qformat(74, 16),)),
           (qformat(74, 16), qformat(40, 8))),
    # f2 (Qu<5,8>, a dot wider than int32): the limb tier now, as in JAX
    "f2": (qformat(5, 8), dict(mul_to=qformat(11, 16),
                               add_formats=(qformat(22, 16),)),
           (qformat(23, 8), qformat(31, 16))),
    # limb-storage operands (path g3)
    "g3": (qformat(70, 10), dict(mul_to=qformat(141, 20),
                                 add_formats=(qformat(152, 20),)),
           (qformat(152, 20),)),
}


@pytest.mark.parametrize("name", list(GEMMS))
def test_qgemul_limb_tier_matches_jax(name, monkeypatch):
    f, kw, outs = GEMMS[name]
    (ja, ta), (jb, tb) = _fill(f, (2, 40), 23), _fill(f, (40, 2), 24)
    tkw = dict(mul_to=P(kw["mul_to"]), add_formats=_P(kw["add_formats"]))
    for out in outs:
        assert _gemm_both(monkeypatch, ja, jb, ta, tb, out, **kw) == \
            ["_fast_gemm_limb"]
        # with the limb tier off: f2 takes the int64 dot in both packages;
        # g1 and g3 the port's layered path, held to the same bits
        if name == "f2":
            with JG.force_tiers_off("limb"), TG.force_tiers_off("limb"):
                assert _gemm_both(monkeypatch, ja, jb, ta, tb, out,
                                  **kw) == ["_fast_gemm_wide"]
        else:
            with TG.force_tiers_off("limb"):
                _same(TG.qgemul(ta, tb, P(out), **tkw),
                      JG.qgemul(ja, jb, out, **kw))


def test_qgemul_streaming_tier_in_limb_values(monkeypatch):
    """The order-sensitive ``Qu<70,10,TRN::TCPL,SAT::ZERO>`` GEMM (path g5)
    on the streaming tier at a small size: k = 20, two chunks of 8 and a
    ragged tail of 4."""
    f = qformat(70, 10, round_mode=RoundMode.TRN_TCPL,
                overflow_mode=OverflowMode.SAT_ZERO)
    (ja, ta), (jb, tb) = _fill(f, (1, 20), 25), _fill(f, (20, 2), 26)
    with JG.stream_gate(0), TG.stream_gate(0):
        assert _gemm_both(monkeypatch, ja, jb, ta, tb, f, mul_to=f,
                          add_formats=(f,)) == ["_stream_gemm_wide"]


def test_cgemul_limb_domain_matches_jax():
    """Wide complex operands whose dots need limbs: the same
    ``info["domain"]`` in both packages and equal raws, Basic and TF."""
    import qublas_tpu.complex as JC

    wide, sums = qformat(63, 16), qformat(32, 8)
    cases = [
        ("basic", qformat(31, 8), dict(ac=wide, bd=wide, ad=wide, bc=wide,
                                       acbd=qformat(64, 16),
                                       adbc=qformat(64, 16)),
         (qformat(74, 16),), None),
        ("tf", qformat(31, 8), dict(ab=sums, cd=sums, ba=sums,
                                    abc=qformat(65, 16), cdb=qformat(65, 16),
                                    bad=qformat(65, 16), AB=qformat(66, 16),
                                    BC=qformat(66, 16)),
         (qformat(77, 16),), qformat(40, 8)),
        ("tf", qformat(3, 4), dict(ab=qformat(5, 4), cd=qformat(5, 4),
                                   ba=qformat(5, 4), abc=qformat(20, 8),
                                   cdb=qformat(20, 8), bad=qformat(20, 8),
                                   AB=qformat(40, 8), BC=qformat(40, 8)),
         (qformat(60, 8),), qformat(50, 8)),
    ]
    for algo, f, tags, layers, out in cases:
        ja = JC.QComplexTensor(JQ.random_fill((2, 6), f, 27),
                               JQ.random_fill((2, 6), f, 28))
        jb = JC.QComplexTensor(JQ.random_fill((6, 2), f, 29),
                               JQ.random_fill((6, 2), f, 30))
        ta, tb = complex_from_jax(ja, "cpu"), complex_from_jax(jb, "cpu")
        ptags = {k: P(v) for k, v in tags.items()}
        po = None if out is None else P(out)
        jd, td = {}, {}
        want = JCG._fast_cgemul(ja, jb, out, out, algo, layers, layers, tags,
                                info=jd)
        got = TCG._fast_cgemul(ta, tb, po, po, algo, _P(layers),
                               _P(layers), ptags, info=td)
        assert jd == td == {"domain": "limb"}
        _same(got.real, want.real)
        _same(got.imag, want.imag)
        got = qt.cgemul(ta, tb, po, algo=algo, add_formats=_P(layers),
                        **ptags)
        _same(got.real, want.real)
        _same(got.imag, want.imag)
