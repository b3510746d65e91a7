"""The torch port's complex elementwise ops against the JAX package and the
compiled reference's goldens, Δ=0.

Inputs come from numpy seeds and cross into each package as raws; formats
cross with ``P`` (the port's own QFormat class) and compare field by field.
Every op runs on CPU tensors (plain torch ops, as on the card).
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from qublas_tpu import complex as JC
from qublas_tpu.qformat import OverflowMode, QFormat, RoundMode, qformat
from qublas_tpu.qtensor import from_raw as jfrom_raw
from qublas_tpu_torch import complex as TC
from qublas_tpu_torch.convert import complex_from_jax, from_jax, port_format
from qublas_tpu_torch.qtensor import from_raw

DATA = pathlib.Path(__file__).parent / "golden_data"

F44 = qformat(4, 4)
F35 = qformat(3, 5)
TAG = qformat(4, 3, round_mode=RoundMode.RND_CONV,
              overflow_mode=OverflowMode.SAT_ZERO)
TAG2 = qformat(5, 2, overflow_mode=OverflowMode.WRP_TCPL)


def P(f):
    return None if f is None else port_format(f)


def _pkw(kw):
    return {k: P(v) for k, v in kw.items()}


def _rand_c(seed, fr, fi, n=12):
    rng = np.random.RandomState(seed)
    return JC.complex_from_raw(rng.randint(fr.raw_min, fr.raw_max + 1, n),
                               rng.randint(fi.raw_min, fi.raw_max + 1, n),
                               fr, fi)


def _port(c):
    return complex_from_jax(c, "cpu")


def _same_part(got, want):
    """Equal raws, lane dtypes and formats; ``want`` from either package."""
    assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
    dt = want.data.dtype
    assert got.data.dtype == (dt if isinstance(dt, torch.dtype)
                              else getattr(torch, str(dt)))
    np.testing.assert_array_equal(got.raw(), np.asarray(want.raw()))


def _same(got, want):
    _same_part(got.real, want.real)
    _same_part(got.imag, want.imag)


CMUL_KW = [{}, dict(ac=TAG, bd=TAG, ad=TAG, bc=TAG, acbd=TAG, adbc=TAG),
           dict(ad=TAG2), dict(ac=TAG, acbd=TAG2)]
TF_KW = [{}, dict(ab=TAG, cd=TAG, abc=TAG, cdb=TAG, bad=TAG, AB=TAG, BC=TAG),
         dict(ba=TAG), dict(ab=TAG, AB=TAG2),
         dict(ab=TAG, cd=TAG, ba=TAG2, abc=TAG, cdb=TAG, bad=TAG, AB=TAG,
              BC=TAG)]


@pytest.mark.parametrize("i", range(len(CMUL_KW)))
def test_cmul_matches_jax(i):
    kw = CMUL_KW[i]
    a, b = _rand_c(i, F44, F35), _rand_c(i + 50, F44, F35)
    _same(TC.cmul(_port(a), _port(b), **_pkw(kw)), JC.cmul(a, b, **kw))


@pytest.mark.parametrize("i", range(len(TF_KW)))
def test_cmul_tf_matches_jax(i):
    kw = TF_KW[i]
    a, b = _rand_c(10 + i, F44, F35), _rand_c(60 + i, F44, F35)
    _same(TC.cmul_tf(_port(a), _port(b), **_pkw(kw)), JC.cmul_tf(a, b, **kw))


@pytest.mark.parametrize("kw", [{}, dict(real_to=TAG), dict(imag_to=TAG2),
                                dict(real_to=TAG, imag_to=TAG2)],
                         ids=["none", "real", "imag", "both"])
def test_cadd_csub_match_jax(kw):
    a, b = _rand_c(20, F44, F35), _rand_c(21, F44, F35)
    ta, tb = _port(a), _port(b)
    _same(TC.cadd(ta, tb, **_pkw(kw)), JC.cadd(a, b, **kw))
    _same(TC.csub(ta, tb, **_pkw(kw)), JC.csub(a, b, **kw))


def test_cneg_ceq_match_jax():
    a, c = _rand_c(22, F44, F35), _rand_c(23, F44, F35)
    _same(TC.cneg(_port(a)), JC.cneg(a))
    for x, y in ((a, a), (a, c)):
        np.testing.assert_array_equal(TC.ceq(_port(x), _port(y)).numpy(),
                                      np.asarray(JC.ceq(x, y)))


@pytest.mark.parametrize("kw", [{}, dict(real_to=TAG), dict(imag_to=TAG2),
                                dict(real_to=TAG, imag_to=TAG2)],
                         ids=["none", "real", "imag", "both"])
def test_real_complex_mul_div_match_jax(kw):
    rng = np.random.RandomState(24)
    r = jfrom_raw(rng.randint(-40, F44.raw_max + 1, 12), F44)
    r = jfrom_raw(np.where(np.asarray(r.raw()) == 0, 3, r.raw()), F44)
    c = _rand_c(25, F44, F35)
    tr, tc = from_jax(r, "cpu"), _port(c)
    _same(TC.rc_mul(tr, tc, **_pkw(kw)), JC.rc_mul(r, c, **kw))
    _same(TC.cr_mul(tc, tr, **_pkw(kw)), JC.cr_mul(c, r, **kw))
    _same(TC.cr_div(tc, tr, **_pkw(kw)), JC.cr_div(c, r, **kw))


@pytest.mark.parametrize("to", [None, TAG], ids=["default", "tagged"])
def test_real_complex_add_sub_match_jax(to):
    rng = np.random.RandomState(26)
    r = jfrom_raw(rng.randint(F44.raw_min, F44.raw_max + 1, 12), F44)
    c = _rand_c(27, F44, F35)
    tr, tc = from_jax(r, "cpu"), _port(c)
    for name in ("rc_add", "rc_sub"):
        _same(getattr(TC, name)(tr, tc, to=P(to)),
              getattr(JC, name)(r, c, to=to))
    for name in ("cr_add", "cr_sub"):
        _same(getattr(TC, name)(tc, tr, to=P(to)),
              getattr(JC, name)(c, r, to=to))


def test_real_op_complex_operators():
    """A QTensor left of a QComplexTensor defers to the complex reflected
    operators: r * c, r + c and r - c are rc_mul, rc_add and rc_sub."""
    rng = np.random.RandomState(28)
    r = jfrom_raw(rng.randint(F44.raw_min, F44.raw_max + 1, 12), F44)
    c = _rand_c(29, F44, F35)
    tr, tc = from_jax(r, "cpu"), _port(c)
    assert tr._ew("qmul", tc) is NotImplemented
    _same(tr * tc, JC.rc_mul(r, c))
    _same(tr + tc, JC.rc_add(r, c))
    _same(tr - tc, JC.rc_sub(r, c))
    _same(tr * tc, TC.rc_mul(tr, tc))
    _same(tc * tr, TC.cr_mul(tc, tr))
    _same(tc + tr, TC.cr_add(tc, tr))
    _same(tc - tr, TC.cr_sub(tc, tr))
    _same(tc / tr, TC.cr_div(tc, tr))
    d = _port(_rand_c(30, F44, F35))
    _same(tc * d, TC.cmul(tc, d))
    _same(tc + d, TC.cadd(tc, d))
    _same(tc - d, TC.csub(tc, d))
    _same(-tc, TC.cneg(tc))


def test_unsupported_divisions_raise():
    a = _port(_rand_c(31, F44, F44))
    r = a.real
    with pytest.raises(NotImplementedError, match="Complex division"):
        a / a
    with pytest.raises(NotImplementedError, match="Complex division"):
        TC.cdiv(a, a)
    with pytest.raises(NotImplementedError, match="Real-Complex division"):
        TC.rc_div(r, a)


def test_tensor_surface():
    c = _rand_c(32, F44, F35, n=24)
    tc = TC.complex_from_raw(np.asarray(c.real.raw()).reshape(4, 6),
                             np.asarray(c.imag.raw()).reshape(4, 6),
                             P(F44), P(F35), device="cpu")
    assert tc.shape == (4, 6) and tc.ndim == 2
    assert tc.fmt == (P(F44), P(F35)) and tc.width == F44.width + F35.width
    assert tc.device == torch.device("cpu") and tc.to("cpu").shape == (4, 6)
    np.testing.assert_array_equal(tc.to_complex().reshape(-1),
                                  np.asarray(c.to_complex()))
    want = JC.complex_from_raw(np.asarray(c.real.raw()).reshape(4, 6)[1:3],
                               np.asarray(c.imag.raw()).reshape(4, 6)[1:3],
                               F44, F35).astype(TAG, TAG2)
    _same(tc[1:3].astype(P(TAG), P(TAG2)), want)
    z = TC.complex_zeros((2, 3), P(F44), device="cpu")
    assert z.fmt == (P(F44), P(F44)) and not z.real.data.any()
    v = TC.complex_from_float([1.5 - 0.25j, -2.0 + 0.5j], P(F44),
                              device="cpu")
    np.testing.assert_allclose(v.to_complex(), [1.5 - 0.25j, -2.0 + 0.5j])
    p = TC.complex_from_parts(tc.real, tc.imag)
    assert p.real is tc.real and "QComplexTensor" in repr(p)
    with pytest.raises(ValueError, match="shape mismatch"):
        TC.QComplexTensor(tc.real, tc.imag[0])


# ---------------------------------------------------------------------------
# the compiled reference's goldens (as tests/test_golden.py reads them)
# ---------------------------------------------------------------------------

def _load(kind):
    p = DATA / f"{kind}.json"
    if not p.exists():
        pytest.skip(f"no goldens for {kind}")
    return json.loads(p.read_text())


def _gfmt(js):
    i, f, s, rm, om = js
    return P(QFormat(i, f, bool(s), RoundMode(rm), OverflowMode(om)))


def _raws(v):
    return np.array([int(x) for x in v], dtype=np.int64)


def _pairs(c):
    return [[int(r), int(i)] for r, i in zip(c.real.raw(), c.imag.raw())]


def test_cmul_golden():
    recs = _load("cmul")
    assert recs
    for rec in recs:
        fr, fi = _gfmt(rec["re"]), _gfmt(rec["im"])
        tag = None if rec["tag"] is None else _gfmt(rec["tag"])
        a = TC.complex_from_raw(_raws(rec["are"]), _raws(rec["aim"]), fr, fi,
                                device="cpu")
        b = TC.complex_from_raw(_raws(rec["bre"]), _raws(rec["bim"]), fr, fi,
                                device="cpu")
        algo = rec["algo"]
        if algo == "default":
            got = TC.cmul(a, b)
        elif algo == "basic":
            got = TC.cmul(a, b, ac=tag, bd=tag, ad=tag, bc=tag, acbd=tag,
                          adbc=tag)
        elif algo == "tf" and tag is None:
            got = TC.cmul_tf(a, b)
        elif algo == "tf":
            got = TC.cmul_tf(a, b, ab=tag, cd=tag, abc=tag, cdb=tag, bad=tag,
                             AB=tag, BC=tag)
        elif algo == "tf_ba_quirk":
            got = TC.cmul_tf(a, b, ba=tag)
        else:  # tf_two
            got = TC.cmul_tf(a, b, ab=tag, AB=tag)
        assert [int(v) for v in got.real.raw()] == \
            [int(v) for v in rec["out_re"]], algo
        assert [int(v) for v in got.imag.raw()] == \
            [int(v) for v in rec["out_im"]], algo
        assert got.fmt == (_gfmt(rec["res_fmt"][0]),
                           _gfmt(rec["res_fmt"][1])), algo


def test_caddsub_golden():
    rec = _load("caddsub")[0]
    fr, fi = P(qformat(4, 4)), P(qformat(3, 5))
    t = P(qformat(3, 2, round_mode=RoundMode.RND_CONV,
                  overflow_mode=OverflowMode.SAT_ZERO))
    u = P(qformat(5, 3))
    a = TC.complex_from_raw(_raws(rec["are"]), _raws(rec["aim"]), fr, fi,
                            device="cpu")
    b = TC.complex_from_raw(_raws(rec["bre"]), _raws(rec["bim"]), fr, fi,
                            device="cpu")
    for got, key in ((TC.cadd(a, b, real_to=t, imag_to=u), "add_two"),
                     (TC.csub(a, b, real_to=t, imag_to=u), "sub_qu2"),
                     (TC.cadd(a, b), "add_none")):
        assert _pairs(got) == [[int(x), int(y)] for x, y in rec[key]], key


def test_realcomplex_golden():
    rec = _load("realcomplex")[0]
    fr, fi = P(qformat(4, 4)), P(qformat(3, 5))
    t, u = P(qformat(4, 3)), P(qformat(5, 2))
    r = from_raw(_raws(rec["rv"]), fr, "cpu")
    c = TC.complex_from_raw(_raws(rec["cre"]), _raws(rec["cim"]), fr, fi,
                            device="cpu")
    for got, key in ((TC.rc_mul(r, c, real_to=t, imag_to=u), "mul_two"),
                     (TC.rc_add(r, c, to=t), "add"),
                     (TC.rc_sub(r, c, to=t), "sub_rc"),
                     (TC.cr_sub(c, r, to=t), "sub_cr")):
        assert _pairs(got) == [[int(x), int(y)] for x, y in rec[key]], key
