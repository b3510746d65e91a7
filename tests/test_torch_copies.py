"""The port's copies of the JAX package's pure-Python modules, Δ=0.

``qublas_tpu_torch`` imports nothing of ``qublas_tpu``, so it carries its
own ``qformat``, ``hostint``, ``hostops``, the width proofs of
``ops.widths`` (``limb_count`` included) and the limb-dot planners
(``gemm.limb_dot_plan``; ``limbdot.digits_needed``, ``work_bits`` and
``_seg_len``).  Each copy must answer as its original does over a seeded
sweep: formats compare field by field (the two packages' QFormat classes
differ), everything else by value.
"""

import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

from qublas_tpu import hostint as JI
from qublas_tpu import hostops as JO
from qublas_tpu.ops import widths as JW
from qublas_tpu_torch import hostint as TI
from qublas_tpu_torch import hostops as TO
from qublas_tpu_torch.convert import port_format as P
from qublas_tpu_torch.ops import widths as TW

# the packages export a function named qformat beside the module
JF = importlib.import_module("qublas_tpu.qformat")
TF = importlib.import_module("qublas_tpu_torch.qformat")

MODES = [(rm, om) for rm in JF.RoundMode for om in JF.OverflowMode]
MODE_IDS = [f"{r.name}-{o.name}" for r, o in MODES]


def _t(x):
    """Field tuple of a format or interval (or nested tuples of them)."""
    if dataclasses.is_dataclass(x):
        return dataclasses.astuple(x)
    if isinstance(x, (tuple, list)):
        return tuple(_t(v) for v in x)
    return x


def _fmts(rm, om):
    """Formats in one mode pair: negative widths, int8..int32 storage,
    signed and unsigned, wide."""
    return [JF.QFormat(i, f, s, rm, om)
            for i, f in ((3, 4), (4, -2), (-2, 6), (7, 8), (15, 16), (1, 30),
                         (40, 8))
            for s in (True, False)]


def test_mode_values_match():
    assert [(m.name, int(m)) for m in TF.RoundMode] == \
        [(m.name, int(m)) for m in JF.RoundMode]
    assert [(m.name, int(m)) for m in TF.OverflowMode] == \
        [(m.name, int(m)) for m in JF.OverflowMode]
    assert _t(TF.QFormat()) == _t(JF.QFormat())
    with pytest.raises(ValueError):
        TF.QFormat(-3, 2)


@pytest.mark.parametrize("rm,om", MODES, ids=MODE_IDS)
def test_format_mergers_match(rm, om):
    fmts = _fmts(rm, om)
    other = JF.QFormat(6, 3, True, JF.RoundMode.RND_CONV,
                       JF.OverflowMode.SAT_ZERO)
    for a in fmts:
        pa = P(a)
        assert (pa.storage_bits, pa.width, pa.raw_min, pa.raw_max, pa.scale) \
            == (a.storage_bits, a.width, a.raw_min, a.raw_max, a.scale)
        assert repr(pa) == repr(a)
        assert _t(pa.with_modes(JF.RoundMode.RND_INF)) == \
            _t(a.with_modes(JF.RoundMode.RND_INF))
        assert _t(TF.qformat(a.int_bits, a.frac_bits, a.signed, int(rm),
                             int(om))) == \
            _t(JF.qformat(a.int_bits, a.frac_bits, a.signed, int(rm),
                          int(om)))
        for b in (fmts[0], fmts[5], other):
            for full in (False, True):
                for merge in ("mul_merge", "add_merge"):
                    tm, jm = getattr(TF, merge), getattr(JF, merge)
                    assert _t(tm(pa, P(b), None, full)) == \
                        _t(jm(a, b, None, full))
                    assert _t(tm(pa, P(b), P(other), full)) == \
                        _t(jm(a, b, other, full))
                    over = {"frac_bits": 9, "signed": False}
                    assert _t(tm(pa, P(b), over, full)) == \
                        _t(jm(a, b, over, full))


def _ints(rng, n=120):
    big = [0, 1, -1, (1 << 31) - 1, -(1 << 31), (1 << 40) + 3, -(1 << 70)]
    return big + [int(v) for v in rng.randint(-(1 << 20), 1 << 20, n)]


@pytest.mark.parametrize("rm,om", MODES, ids=MODE_IDS)
def test_hostint_matches(rm, om):
    rng = np.random.RandomState(int(rm) * 8 + int(om))
    for f in _fmts(rm, om):
        pf = P(f)
        for v in _ints(rng):
            for fr in (-3, 0, 5, 40):
                assert TI.frac_convert(v, fr, f.frac_bits, P(f).round_mode) \
                    == JI.frac_convert(v, fr, f.frac_bits, rm)
                assert TI.requantize(v, fr, pf) == JI.requantize(v, fr, f)
            assert TI.int_convert(v, pf) == JI.int_convert(v, f)
            if v:
                for b in (3, -7, v // 3 or 1):
                    assert TI.trunc_div(v, b) == JI.trunc_div(v, b)
            assert TI.raw_to_double(v, pf) == JI.raw_to_double(v, f)
        for x in list(rng.standard_normal(40) * 300) + [
                0.0, -0.0, 0.5, -2.5, 1e300, -1e-300, math.inf, math.nan]:
            assert TI.double_to_raw(float(x), pf) == \
                JI.double_to_raw(float(x), f)


@pytest.mark.parametrize("rm,om", MODES, ids=MODE_IDS)
def test_hostops_match(rm, om):
    rng = np.random.RandomState(100 + int(rm) * 8 + int(om))
    fmts = _fmts(rm, om)[:8]
    to = JF.QFormat(5, 3, True, rm, om)
    for fa in fmts:
        for fb in fmts[::3]:
            for _ in range(6):
                a = (int(rng.randint(fa.raw_min, fa.raw_max + 1)), fa)
                b = (int(rng.randint(fb.raw_min, fb.raw_max + 1)), fb)
                ta, tb = (a[0], P(fa)), (b[0], P(fb))
                for op in ("qmul", "qadd", "qsub", "qdiv"):
                    for kw in ({}, {"to": to}, {"full_prec": True}):
                        tkw = {k: P(v) if k == "to" else v
                               for k, v in kw.items()}
                        assert _t(getattr(TO, op)(ta, tb, **tkw)) == \
                            _t(getattr(JO, op)(a, b, **kw))
                assert TO.qcmp(ta, tb) == JO.qcmp(a, b)
                assert TO.qeq(ta, tb) == JO.qeq(a, b)
                assert _t(TO.qabs(ta)) == _t(JO.qabs(a))
                assert _t(TO.qneg(ta)) == _t(JO.qneg(a))
                assert _t(TO.convert(ta, P(to))) == _t(JO.convert(a, to))
        assert _t(TO.qdiv((5, P(fa)), (0, P(fa)))) == \
            _t(JO.qdiv((5, fa), (0, fa)))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_hostops_reductions_and_gemm_match(n):
    rng = np.random.RandomState(n)
    f = JF.qformat(4, 4)
    layers = (JF.qformat(5, 3, round_mode=JF.RoundMode.RND_CONV,
                         overflow_mode=JF.OverflowMode.SAT_ZERO),
              JF.qformat(6, 2))
    vals = [(int(v), f) for v in rng.randint(f.raw_min, f.raw_max + 1, n)]
    tvals = [(r, P(f)) for r, _ in vals]
    for lf in ((), layers, layers[0]):
        tl = P(lf) if isinstance(lf, JF.QFormat) else \
            tuple(P(x) for x in lf)
        assert _t(TO.qreduce_list(tvals, tl)) == _t(JO.qreduce_list(vals, lf))
        assert _t(TO.qreduce_args(tvals, tl)) == _t(JO.qreduce_args(vals, lf))
    # a small qgemul with per-product and per-layer formats, transposed A
    A = [[(int(v), f) for v in row]
         for row in rng.randint(f.raw_min, f.raw_max + 1, (n, 3))]
    B = [[(int(v), f) for v in row]
         for row in rng.randint(f.raw_min, f.raw_max + 1, (n, 2))]
    TA = [[(r, P(g)) for r, g in row] for row in A]
    TB = [[(r, P(g)) for r, g in row] for row in B]
    out, mul = JF.qformat(6, 3), JF.qformat(7, 6)
    assert _t(TO.qgemul(TA, TB, P(out), P(mul), tuple(P(x) for x in layers),
                        transpose_a=True)) == \
        _t(JO.qgemul(A, B, out, mul, layers, transpose_a=True))


@pytest.mark.parametrize("rm,om", MODES, ids=MODE_IDS)
def test_widths_match(rm, om):
    fmts = _fmts(rm, om)
    ivs = [JW.Interval(-5, 9), JW.Interval(-(1 << 31), (1 << 31) - 1),
           JW.Interval(0, 1 << 40), JW.Interval(-(1 << 62), 1 << 62)]
    for f in fmts:
        pf = P(f)
        assert TW.storage_kind(pf) == JW.storage_kind(f)
        if JW.storage_kind(f) == "limb":
            assert TW.limb_count(pf) == JW.limb_count(f)
        # the port's storage dtype: the JAX lane dtype, int64 for a pair
        jdt = JW.dtype_for(f)
        assert TW.storage_dtype(pf) == (
            getattr(torch, np.dtype(jdt).name) if jdt is not None else
            torch.int64 if JW.storage_kind(f) == "pair" else None)
        assert _t(TW.fmt_interval(pf)) == _t(JW.fmt_interval(f))
        for iv in ivs:
            tiv = TW.Interval(iv.lo, iv.hi)
            assert (tiv.bits, tiv.fits32, tiv.fits64) == \
                (iv.bits, iv.fits32, iv.fits64)
            for fr in (-4, 0, 3, 33):
                assert _t(TW.rounded_interval(tiv, fr, pf)) == \
                    _t(JW.rounded_interval(iv, fr, f))
                assert _t(TW.requant_out_interval(tiv, fr, pf)) == \
                    _t(JW.requant_out_interval(iv, fr, f))
                assert TW.route_requant(tiv, fr, pf) == \
                    JW.route_requant(iv, fr, f)
                assert TW.requant_work_bits(tiv, fr, pf) == \
                    JW.requant_work_bits(iv, fr, f)
        for g in fmts[::2]:
            for out in (f, g, fmts[3]):
                args_t, args_j = (pf, P(g), P(out)), (f, g, out)
                assert TW.split_mul_ok(*args_t) == JW.split_mul_ok(*args_j)
                assert _t(TW.route_mul(*args_t)) == _t(JW.route_mul(*args_j))
                assert _t(TW.route_div(*args_t)) == _t(JW.route_div(*args_j))
                for sub in (False, True):
                    assert _t(TW.route_addsub(*args_t, sub)) == \
                        _t(JW.route_addsub(*args_j, sub))


@pytest.mark.parametrize("om", list(JF.OverflowMode),
                         ids=[o.name for o in JF.OverflowMode])
def test_limb_count_matches(om):
    for bits in (33, 63, 64, 65, 96, 97, 128, 129, 200, 511, 992, 993):
        f = JF.QFormat(bits - 1, 0, True, JF.RoundMode.TRN_TCPL, om)
        assert TW.storage_kind(P(f)) == JW.storage_kind(f)
        if JW.storage_kind(f) == "limb":
            assert TW.limb_count(P(f)) == JW.limb_count(f)


def test_limb_dot_planners_match():
    """``limb_dot_plan`` and the digit planners it rests on, over operand
    widths from int8 lanes to 200-bit limbs, k from 1 to 2^20 and output
    formats of every storage kind."""
    from qublas_tpu.ops import gemm as JG
    from qublas_tpu.ops import limbdot as JD
    from qublas_tpu_torch.ops import gemm as TG
    from qublas_tpu_torch.ops import limbdot as TD

    widths = [(3, 4), (5, 8), (15, 16), (31, 8), (62, 0), (70, 10),
              (120, 40), (199, 0)]
    ks = [1, 7, 64, 1000, 2048, 40000, 1 << 20]
    for ib, fb in widths:
        iv = JW.fmt_interval(JF.QFormat(ib, fb))
        tiv = TW.Interval(iv.lo, iv.hi)
        assert TD.digits_needed(tiv) == JD.digits_needed(iv)
        for ib2, fb2 in widths[::3]:
            iv2 = JW.fmt_interval(JF.QFormat(ib2, fb2))
            tiv2 = TW.Interval(iv2.lo, iv2.hi)
            assert TD.digit_matmuls(tiv, tiv2) == JD.digit_matmuls(iv, iv2)
            for k in ks:
                assert TD.work_bits(tiv, tiv2, k) == JD.work_bits(iv, iv2, k)
    for k in ks:
        for g in range(1, 60, 7):
            assert TD._seg_len(k, g) == JD._seg_len(k, g)
    outs = [JF.QFormat(7, 0), JF.QFormat(40, 8), JF.QFormat(74, 16),
            JF.QFormat(300, 20, True, JF.RoundMode.RND_CONV,
                       JF.OverflowMode.SAT_ZERO), JF.QFormat(1000, 0)]
    assert TG._LIMBDOT_MAX_MATMULS == JG._LIMBDOT_MAX_MATMULS
    assert TG._LIMBDOT_MAX_DOT_ELEMS == JG._LIMBDOT_MAX_DOT_ELEMS
    checked = set()
    for ib, fb in widths:
        fa = JF.QFormat(ib, fb)
        mul = JF.QFormat(2 * ib + 1, 2 * fb)   # holds every product
        for k in (2, 64, 2048):
            plan = JG.exact_plan(fa, fa, mul, (JF.QFormat(mul.int_bits + 12,
                                                          mul.frac_bits),),
                                 k)
            tplan = TG.exact_plan(P(fa), P(fa), P(mul), (P(JF.QFormat(
                mul.int_bits + 12, mul.frac_bits)),), k)
            assert (plan is None) == (tplan is None)
            if plan is None:
                continue
            for out in outs:
                for m, n in ((1, 1), (64, 64), (2048, 2048)):
                    kw = JG.limb_dot_plan(fa, fa, out, plan, k, m, n)
                    assert TG.limb_dot_plan(P(fa), P(fa), P(out), tplan, k,
                                            m, n) == kw
                    checked.add(kw)
    # admitted at several working widths, and refused
    assert None in checked and len(checked) >= 4


# ---------------------------------------------------------------------------
# bitstream (the port's copy of qublas_tpu/bitstream.py)
# ---------------------------------------------------------------------------

def _bs_orders(bs):
    return [(None, None), (bs.r2l(1), None), (None, bs.r2l(1)),
            (bs.r2l(3), bs.r2l(2)), (bs.r2l(2), bs.r2l(5))]


@pytest.mark.parametrize("signed", [True, False])
def test_bitstream_matches(signed):
    """Serialize and parse through both copies: the same strings and raws,
    every order, both parse modes, wart raws included."""
    from qublas_tpu import bitstream as JB
    from qublas_tpu.complex import complex_from_raw as jcomplex
    from qublas_tpu.qtensor import from_raw as jraw
    from qublas_tpu_torch import bitstream as TB
    from qublas_tpu_torch.convert import complex_from_jax, from_jax

    rng = np.random.RandomState(31 + signed)
    f = JF.qformat(6, 3, signed)                      # width 10 or 9
    raws = rng.randint(f.raw_min, f.raw_max + 1, 12)
    raws[0] = f.raw_min - 5 if signed else -3         # a wart raw
    t = jraw(raws.reshape(3, 4), f)
    pt = from_jax(t, "cpu")
    for tord, eord in _bs_orders(JB)[:4 if signed else 3]:
        s = JB.to_bits(t, tord, eord)
        tt = TB.r2l(tord.chunk) if tord else None
        te = TB.r2l(eord.chunk) if eord else None
        assert TB.to_bits(pt, tt, te) == s
        for tc in (False, True):
            back = TB.from_bits(s, P(f), (3, 4), tt, te, tc, device="cpu")
            want = JB.from_bits(s, f, (3, 4), tord, eord, tc)
            assert _t(back.fmt) == _t(want.fmt)
            assert back.raw().tolist() == \
                np.asarray(want.raw(), dtype=np.int64).tolist()
    scalar = jraw(np.array(int(raws[1])), f)
    s = JB.to_bits(scalar, elem_order=JB.r2l(1))
    assert TB.to_bits(from_jax(scalar, "cpu"), elem_order=TB.r2l(1)) == s
    assert int(TB.from_bits(s, P(f), elem_order=TB.r2l(1),
                            device="cpu").raw()) == \
        int(np.asarray(JB.from_bits(s, f, elem_order=JB.r2l(1)).raw()))
    fi = JF.qformat(4, 1)
    c = jcomplex(raws[:6], rng.randint(fi.raw_min, fi.raw_max + 1, 6), f, fi)
    pc = complex_from_jax(c, "cpu")
    s = JB.to_bits_complex(c, JB.r2l(2), None)
    assert TB.to_bits_complex(pc, TB.r2l(2), None) == s == \
        pc.to_bits(TB.r2l(2))
    back = TB.from_bits_complex(s, P(f), P(fi), (6,), TB.r2l(2), None,
                                twos_complement=True, device="cpu")
    want = JB.from_bits_complex(s, f, fi, (6,), JB.r2l(2), None,
                                twos_complement=True)
    assert back.real.raw().tolist() == \
        np.asarray(want.real.raw(), dtype=np.int64).tolist()
    assert back.imag.raw().tolist() == \
        np.asarray(want.imag.raw(), dtype=np.int64).tolist()
    with pytest.raises(ValueError):
        TB.to_bits(pt, None, TB.r2l(4))
    with pytest.raises(ValueError, match="expected"):
        TB.from_bits(s[:-1], P(f), (3,), device="cpu")


def test_bitstream_goldens():
    """The port's copy against the compiled reference's BitStream goldens
    (as tests/test_golden.py reads them)."""
    import json
    import pathlib

    from qublas_tpu_torch import bitstream as TB
    from qublas_tpu_torch.complex import complex_from_raw
    from qublas_tpu_torch.qtensor import from_raw

    data = pathlib.Path(__file__).parent / "golden_data"

    def load(kind):
        return json.loads((data / f"{kind}.json").read_text())[0]

    rec = load("bitstream_demo")
    f = TF.qformat(5, 0)
    t = from_raw(np.arange(1, 7).reshape(2, 3), f, "cpu")
    s = TB.to_bits(t, TB.r2l(1), None)
    assert s == rec["str"]
    z = TB.from_bits_complex(s, f, f, (3,), device="cpu")
    assert [[int(r), int(i)] for r, i in zip(z.real.raw(), z.imag.raw())] \
        == rec["parsed"]

    rec = load("bitstream_r2l")
    f = TF.qformat(6, 3, overflow_mode=TF.OverflowMode.SAT_ZERO)
    t = from_raw(np.array([int(v) for v in rec["raws"]]), f, "cpu")
    s = TB.to_bits(t, TB.r2l(3), TB.r2l(2))
    assert s == rec["str"]
    back = TB.from_bits(s, f, (6,), TB.r2l(3), TB.r2l(2), device="cpu")
    assert [int(v) for v in back.raw()] == [int(v) for v in rec["back"]]

    rec = load("bitstream_scalar")
    t = from_raw(np.array(int(rec["raw"])), TF.qformat(4, 3), "cpu")
    assert TB.to_bits(t) == rec["l2r"]
    assert TB.to_bits(t, elem_order=TB.r2l(1)) == rec["r2l1"]

    rec = load("bitstream_complex")
    f = TF.qformat(3, 2)
    c = complex_from_raw(np.array([5, -32]), np.array([-3, 31]), f,
                         device="cpu")
    assert TB.to_bits_complex(c) == \
        "".join(ch for ch in rec["str"] if ch in "01")
