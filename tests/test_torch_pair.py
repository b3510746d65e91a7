"""Pair storage (33..64-bit formats) in the torch port against the JAX
package, Δ=0 in raws, storage and format fields.

The JAX package holds a pair-storage format as a (hi: int32, lo: uint32)
``PairArray``; the port holds it in one int64 tensor.  Here, on seeded
inputs:

* ``wideint.requantize_i64`` against ``requantize_pair_keep`` and
  ``requantize_pair`` over every rounding x overflow mode and the shifts
  0, 1, 31, 32, 33, 62 and 63 (left shifts too), and against the exact host
  model at shifts of 64 and more; ``div_trunc_i64`` against
  ``pair_div_trunc`` at the division-by-zero and ``INT64_MIN`` corners;
* every pair route of the elementwise ops in every mode, the corners
  included;
* QTensor's constructors, ``from_jax`` of a pair tensor, ``qreduce``
  through and into pair formats, ``QTable`` into a pair format;
* the plain versions of K2, K2′ and P1 on the 64-bit product route against
  ``tree_gemm_scan`` and the JAX package's ``_product``/``_merge`` chain;
  the route's code in the kernels' parameters and in the compiled-plan
  tables;
* ``qgemul``'s lossless wide tier and its streaming tier (both packages'
  ``stream_gate(0)``) and layered path against the JAX package's
  ``qgemul``.

The kernels' pair route on the card is held against these plain versions
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu import anus as JA
from qublas_tpu import qtensor as JQ
from qublas_tpu.ops import elementwise as JE
from qublas_tpu.ops import gemm as JG
from qublas_tpu.ops import reduce as JR
from qublas_tpu.ops import tree_gemm as JT
from qublas_tpu.ops import wideint as JW
from qublas_tpu.qformat import (OverflowMode, QFormat, RoundMode, mul_merge,
                                qformat)
from qublas_tpu_torch import anus as TA
from qublas_tpu_torch import hostint
from qublas_tpu_torch.convert import from_jax
from qublas_tpu_torch.convert import port_format
from qublas_tpu_torch.ops import chain_probe as CP
from qublas_tpu_torch.ops import gemm as TG
from qublas_tpu_torch.ops import tree_gemm as TT
from qublas_tpu_torch.ops import wideint as TW

MODES = [(rm, om) for rm in RoundMode for om in OverflowMode]
MODE_IDS = [f"{r.name}-{o.name}" for r, o in MODES]
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def P(f):
    """The port's QFormat of a JAX-package format (or tuple of them)."""
    if f is None:
        return None
    if isinstance(f, tuple):
        return tuple(P(x) for x in f)
    return port_format(f)


def _same(got, want):
    """A port QTensor (or tensor) equals a JAX-package one: format fields,
    storage (int64 for a JAX pair) and raws."""
    if hasattr(want, "fmt"):
        assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
        assert got.is_pair == want.is_pair
        assert (got.is_limb, got.is_host) == (want.is_limb, want.is_host)
        if got.is_limb or got.is_host:
            np.testing.assert_array_equal(got.raw(), want.raw())
            return
        got, want = got.data, want.raw()
    w = np.asarray(want)
    assert got.dtype == getattr(torch, str(w.dtype)), (got.dtype, w.dtype)
    np.testing.assert_array_equal(got.numpy(), w)


def _raws(rng, fmt, n, zeros=False):
    """``n`` seeded raws of the format's storage range, its edges first."""
    lo, hi = fmt.raw_min, fmt.raw_max
    edges = [e for e in (lo, hi, 0, 1, -1, lo + 1, hi - 1, 1 << 31,
                         -(1 << 31), (1 << 32) + 3) if lo <= e <= hi]
    span = hi - lo + 1
    r = np.array([lo + int.from_bytes(rng.bytes(9), "little") % span
                  for _ in range(n)], dtype=np.int64)
    r[:len(edges)] = edges
    if zeros:
        r[::5] = 0
    return r


def _both(raws, fmt):
    return JQ.from_raw(raws, fmt), qt.from_raw(raws, P(fmt), "cpu")


# ---------------------------------------------------------------------------
# wideint: requantize_i64 and div_trunc_i64
# ---------------------------------------------------------------------------

def _values(seed, n=64):
    """int64 values over the whole word: its edges, the 32-bit edges, and
    seeded values of every magnitude."""
    rng = np.random.RandomState(seed)
    edges = [I64_MIN, I64_MIN + 1, I64_MAX, I64_MAX - 1, 0, 1, -1, 2, -2,
             1 << 31, -(1 << 31), (1 << 32) - 1, -(1 << 32), 1 << 62,
             -(1 << 62), 3 << 60, -(3 << 60)]
    mags = rng.randint(0, 63, n)
    vals = [int(rng.randint(-(1 << 30), 1 << 30)) << int(s) for s in mags]
    return np.array(edges + [max(min(v, I64_MAX), I64_MIN) for v in vals],
                    dtype=np.int64)


@pytest.mark.parametrize("rm,om", MODES, ids=MODE_IDS)
def test_requantize_i64_matches_pair_requantize(rm, om):
    x = _values(int(rm) * 5 + int(om))
    hi, lo = JW.pair_from_int64_np(x).hi, JW.pair_from_int64_np(x).lo
    tx = torch.from_numpy(x)
    for d in (0, 1, 31, 32, 33, 62, 63, -1, -20):
        for signed in (True, False):
            # destinations of lane storage and of pair storage (33..64)
            for bits in (8, 20, 32, 33, 48, 64):
                fmt = QFormat(bits - 1 - 3, 3, signed, rm, om)
                from_frac = fmt.frac_bits + d
                got = TW.requantize_i64(tx, from_frac, P(fmt))
                assert got.dtype == torch.int64
                if bits <= 32:
                    want = np.asarray(JW.requantize_pair((hi, lo), from_frac,
                                                         fmt))
                    np.testing.assert_array_equal(
                        got.to(torch.int32).numpy(), want, err_msg=str(
                            (d, fmt)))
                else:
                    h, l = JW.requantize_pair_keep((hi, lo), from_frac, fmt)
                    want = JW.PairArray(h, l).to_numpy_int64()
                    np.testing.assert_array_equal(got.numpy(), want,
                                                  err_msg=str((d, fmt)))


@pytest.mark.parametrize("rm,om", MODES, ids=MODE_IDS)
def test_requantize_i64_wide_shifts_match_host(rm, om):
    """Shifts of 64 and more (beyond the JAX package's pair helpers, which
    the width proofs keep below 64) against the exact host model, for
    values inside the pair margin."""
    x = _values(int(rm) * 7 + int(om))
    x = x[x != I64_MIN]
    tx = torch.from_numpy(x)
    for d in (64, 65, 100):
        for fmt in (QFormat(20, 3, True, rm, om), QFormat(44, 3, False, rm,
                                                          om)):
            got = TW.requantize_i64(tx, fmt.frac_bits + d, P(fmt)).tolist()
            want = [hostint.requantize(int(v), fmt.frac_bits + d, P(fmt))
                    for v in x]
            assert got == want, (d, fmt)


def test_div_trunc_i64_matches_pair_division():
    num = np.array([I64_MIN, I64_MIN, I64_MIN, I64_MAX, 7, -7, 7, -7, 0, 5,
                    I64_MIN + 1, 123456789012345, -(1 << 40), 9, I64_MIN],
                   dtype=np.int64)
    den = np.array([-1, 1, 2, -1, 2, 2, -2, -2, 3, 0, -1, -97, 0, I64_MIN,
                    I64_MIN], dtype=np.int64)
    a, b = JW.pair_from_int64_np(num), JW.pair_from_int64_np(den)
    q = JW.pair_div_trunc((a.hi, a.lo), (b.hi, b.lo))
    want = JW.PairArray(*q).to_numpy_int64()
    want = np.where(den == 0, 0, want)          # the caller's zero wart
    got = TW.div_trunc_i64(torch.from_numpy(num), torch.from_numpy(den))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == I64_MIN and got[9] == 0


def test_mul_wide_is_the_exact_product():
    a = torch.tensor([-(1 << 31), (1 << 31) - 1, -(1 << 31), 5],
                     dtype=torch.int32)
    b = torch.tensor([-(1 << 31), (1 << 31) - 1, (1 << 31) - 1, -7],
                     dtype=torch.int32)
    assert TW.mul_wide(a, b).tolist() == [
        1 << 62, ((1 << 31) - 1) ** 2, -(1 << 31) * ((1 << 31) - 1), -35]


# ---------------------------------------------------------------------------
# QTensor, from_jax, the three motivating calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", [qformat(16, 16), qformat(40, 23),
                                 qformat(62, 1, signed=False),
                                 qformat(31, 1)],
                         ids=["33", "64", "64-unsigned", "33-wart"])
def test_qtensor_pair_storage_matches_jax(fmt):
    rng = np.random.RandomState(fmt.storage_bits)
    raws = _raws(rng, fmt, 30).reshape(5, 6)
    j, t = _both(raws, fmt)
    assert t.is_pair and j.is_pair and t.data.dtype == torch.int64
    _same(t, j)
    np.testing.assert_array_equal(t.to_double(), j.to_double())
    _same(qt.zeros((2, 3), P(fmt), "cpu"), JQ.zeros((2, 3), fmt))
    _same(qt.random_fill((4, 5), P(fmt), seed=3, device="cpu"),
          JQ.random_fill((4, 5), fmt, seed=3))
    vals = np.array([0.0, -1.5, 3.25, 1e9, -1e12, 2.0 ** 40, np.nan])
    _same(qt.from_float(vals, P(fmt), "cpu"), JQ.from_float(vals, fmt))
    # the fill(int) wart: raws past the format, inside the 64-bit word
    wart = np.array([I64_MIN, I64_MAX, 3])
    _same(qt.from_raw(wart, P(fmt), "cpu"), JQ.from_raw(wart, fmt))
    _same(t[1:3, ::2], JQ.QTensor(j.data[1:3, ::2], fmt))


def test_from_jax_takes_a_pair_tensor():
    f = qformat(20, 30)
    j = JQ.random_fill((3, 7), f, seed=5)
    assert j.is_pair and np.asarray(j.raw()).dtype == np.int64
    t = from_jax(j, "cpu")
    assert t.is_pair and t.shape == (3, 7)
    _same(t, j)


def test_beyond_pair_storage_raises():
    """Beyond pair storage: a 71-bit format takes limb storage; raws beyond
    the storage word and formats beyond 992 bits take host storage, as in
    the JAX package (an object array of Python ints)."""
    f70 = qformat(70, 0)
    t = qt.from_raw([1, -(1 << 70)], P(f70), "cpu")
    assert t.is_limb and not t.is_pair
    _same(t, JQ.from_raw(np.array([1, -(1 << 70)], dtype=object), f70))
    for raws, f in ((np.array([1 << 70], dtype=object), qformat(40, 0)),
                    (np.array([1], dtype=object), qformat(1000, 0))):
        t, j = qt.from_raw(raws, P(f), "cpu"), JQ.from_raw(raws, f)
        assert t.is_host and j.is_host and t.device == torch.device("cpu")
        assert dataclasses.astuple(t.fmt) == dataclasses.astuple(j.fmt)
        np.testing.assert_array_equal(t.raw(), j.raw())
    with pytest.raises(TypeError, match="int64"):
        qt.QTensor(torch.zeros(3, dtype=torch.int32), P(qformat(40, 0)))


def test_motivating_calls_match_jax():
    """Full-precision ``qmul`` of the canonical ``Qu<8,8>``, ``+`` of two
    Q16.16 tensors, and ``qgemul`` on ``Qu<12,12,TRN::TCPL,SAT::ZERO>``."""
    rng = np.random.RandomState(9)
    f88 = qformat(8, 8)
    ja, ta = _both(_raws(rng, f88, 42).reshape(6, 7), f88)
    _same(qt.qmul(ta, ta, full_prec=True), JE.qmul(ja, ja, full_prec=True))
    assert qt.qmul(ta, ta, full_prec=True).is_pair
    q16 = qformat(15, 16)
    jb, tb = _both(_raws(rng, q16, 42).reshape(6, 7), q16)
    _same(tb + tb, jb + jb)
    f12 = qformat(12, 12, round_mode=RoundMode.TRN_TCPL,
                  overflow_mode=OverflowMode.SAT_ZERO)
    A = _raws(rng, f12, 6 * 40).reshape(6, 40)
    B = _raws(rng, f12, 40 * 5).reshape(40, 5)
    want = JG.qgemul(JQ.from_raw(A, f12), JQ.from_raw(B, f12), f12,
                     use_pallas=False)
    got = qt.qgemul(qt.from_raw(A, P(f12), "cpu"),
                    qt.from_raw(B, P(f12), "cpu"), P(f12))
    _same(got, want)


# ---------------------------------------------------------------------------
# The elementwise ops' pair routes
# ---------------------------------------------------------------------------

def _compare(name, jargs, targs, **kw):
    want = getattr(JE, name)(*jargs, **kw)
    tkw = {k: P(v) if k == "to" and v is not None else v
           for k, v in kw.items()}
    got = getattr(qt, name)(*targs, **tkw)
    if name in ("qcmp", "qeq"):
        _same(got, np.asarray(want))
    else:
        _same(got, want)


@pytest.mark.parametrize("rm,om", MODES, ids=MODE_IDS)
def test_pair_routes_match_jax(rm, om):
    rng = np.random.RandomState(int(rm) * 5 + int(om))
    f = lambda i, fr, s=True: QFormat(i, fr, s, rm, om)  # noqa: E731
    # WRP_TCPL_SAT formats hold the whole storage word, so pair-storage
    # operands of that mode need limbs; their results take it all the same
    om_in = OverflowMode.SAT_TCPL if om == OverflowMode.WRP_TCPL_SAT else om
    g = lambda i, fr: QFormat(i, fr, True, rm, om_in)  # noqa: E731
    lane, mid, wide = f(15, 16), g(20, 20), g(30, 22)
    ja, ta = _both(_raws(rng, lane, 48), lane)
    jb, tb = _both(_raws(rng, lane, 48, zeros=True), lane)
    jc, tc = _both(_raws(rng, mid, 48), mid)
    jd, td = _both(_raws(rng, wide, 48, zeros=True), wide)
    js, ts = _both(_raws(rng, g(5, 4), 48), g(5, 4))
    cases = [
        # products: 64-bit, into lanes and into pair storage
        ("qmul", (ja, jb), (ta, tb), {}),
        ("qmul", (ja, jb), (ta, tb), {"to": f(30, 20)}),
        ("qmul", (ja, jb), (ta, tb), {"full_prec": True}),
        ("qmul", (jc, js), (tc, ts), {"to": f(12, 10)}),
        ("qmul", (js, jd), (ts, td), {}),
        # sums and differences of lanes, of pairs, into both
        ("qadd", (ja, jb), (ta, tb), {}),
        ("qsub", (ja, jb), (ta, tb), {"to": f(40, 16)}),
        ("qadd", (jc, jd), (tc, td), {}),
        ("qsub", (jd, jc), (td, tc), {"to": f(10, 5)}),
        ("qadd", (jc, ja), (tc, ta), {"full_prec": True}),
        # quotients: wide numerators, pair operands, zero divisors
        ("qdiv", (ja, jb), (ta, tb), {}),
        ("qdiv", (jc, jb), (tc, tb), {"to": f(40, 10)}),
        ("qdiv", (jd, jd), (td, td), {"to": f(20, 3)}),
        ("qabs", (jc,), (tc,), {}), ("qneg", (jd,), (td,), {}),
        ("qneg", (ja,), (ta,), {}),
        ("qcmp", (jc, jd), (tc, td), {}), ("qeq", (jc, jc), (tc, tc), {}),
        ("qcmp", (ja, jc), (ta, tc), {}),
        ("qcast", (jd, f(12, 30)), (td, P(f(12, 30))), {}),
        ("qcast", (jc, f(5, 2)), (tc, P(f(5, 2))), {}),
        ("qcast", (ja, f(28, 30)), (ta, P(f(28, 30))), {}),
    ]
    for name, jargs, targs, kw in cases:
        _compare(name, jargs, targs, **kw)


def test_pair_corners_match_jax():
    """``INT64_MIN`` (a wart raw of a 63-bit format) divided by -1 and
    negated, and division by zero, on the pair routes."""
    f = qformat(62, 0)
    num = np.array([I64_MIN, I64_MIN, 5, -(1 << 62), I64_MIN, 7, I64_MAX])
    den = np.array([-1, 0, 0, -1, 1, 2, -1])
    (ja, ta), (jb, tb) = _both(num, f), _both(den, f)
    for name, args in (("qdiv", 2), ("qneg", 1), ("qabs", 1), ("qcmp", 2),
                       ("qeq", 2)):
        _compare(name, (ja, jb)[:args], (ta, tb)[:args])
    for to in (qformat(62, 0, overflow_mode=OverflowMode.SAT_ZERO),
               qformat(20, 0, overflow_mode=OverflowMode.WRP_TCPL)):
        _compare("qdiv", (ja, jb), (ta, tb), to=to)


def test_limb_routes_still_raise():
    """The limb routes of pair operands, which raised before limb storage
    was ported, compute Δ=0 against the JAX package."""
    f = qformat(40, 0)
    j, t = _both(np.arange(6) - 3, f)
    _compare("qmul", (j, j), (t, t))        # an 82-bit product
    _compare("qadd", (j, j), (t, t), to=qformat(70, 0))


# ---------------------------------------------------------------------------
# qreduce and QTable
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,layers,n", [
    (qformat(20, 10), (qformat(40, 10),), 13),
    (qformat(20, 10), (qformat(31, 10), qformat(45, 8, round_mode=RoundMode.
                                                    RND_CONV)), 64),
    (qformat(30, 20), (), 7),
    (qformat(30, 20, overflow_mode=OverflowMode.SAT_ZERO),
     (qformat(30, 20, overflow_mode=OverflowMode.SAT_ZERO),
      qformat(10, 5, round_mode=RoundMode.RND_INF)), 33),
    (qformat(15, 16), (), 9),
], ids=["into-pair", "through-pair", "pair-in", "pair-to-lane", "q16-sums"])
def test_qreduce_pair_matches_jax(fmt, layers, n):
    rng = np.random.RandomState(n)
    raws = _raws(rng, fmt, 4 * n).reshape(4, n)
    j, t = _both(raws, fmt)
    _same(qt.qreduce(t, P(layers), axis=1), JR.qreduce(j, layers, axis=1))
    if n == 7:
        _same(qt.qreduce(t, P(layers)), JR.qreduce(j, layers))


def test_qtable_into_pair_storage_matches_jax():
    fin = qformat(3, 4)
    out = qformat(30, 25, round_mode=RoundMode.RND_CONV)
    jt = JA.QTable(JA.reciprocal_func, fin, out)
    tt = TA.QTable(TA.reciprocal_func, P(fin), P(out))
    assert tt.table.dtype == torch.int64
    pats = np.arange(1 << fin.width)
    raws = np.where(pats >= 128, pats - 256, pats)
    j, t = _both(raws, fin)
    got = tt(t)
    assert got.is_pair
    _same(got, jt(j))


# ---------------------------------------------------------------------------
# K2, K2′ and P1 on the 64-bit product route (plain versions)
# ---------------------------------------------------------------------------

F12 = qformat(12, 12, round_mode=RoundMode.TRN_TCPL,
              overflow_mode=OverflowMode.SAT_ZERO)


def _pair_plan(fmt, k, layers=(), out=None, fb=None, mul=None):
    out, fb = out or fmt, fb or fmt
    mul = mul or mul_merge(fmt, fb)
    jplan = JT.plan_tree(fmt, fb, mul, layers, k, out)
    tplan = TT.plan_tree(P(fmt), P(fb), P(mul), P(layers), k, P(out))
    assert jplan.prod_route == tplan.prod_route == "pair"
    return jplan, tplan


@pytest.mark.parametrize("rm,om", MODES, ids=MODE_IDS)
def test_tree_gemm_pair_route_matches_scan(rm, om):
    """Products of 25-bit by 15-bit lanes requantized into a 25-bit mul
    format with each mode pair; the tree's layers saturate (a
    WRP_TCPL_SAT layer's sums would outgrow int32)."""
    om_in = OverflowMode.SAT_TCPL if om == OverflowMode.WRP_TCPL_SAT else om
    fa, fb = QFormat(12, 12, True, rm, om_in), QFormat(2, 12, True, rm, om_in)
    mul = QFormat(12, 12, True, rm, om)
    layers = (QFormat(13, 12, True, rm, om_in),)
    out = QFormat(9, 5, False, rm, om)
    for k in (37,):
        jplan, tplan = _pair_plan(fa, k, layers, out, fb, mul)
        rng = np.random.RandomState(k)
        A = _raws(rng, fa, 5 * k).reshape(5, k).astype(np.int32)
        B = _raws(rng, fb, k * 6).reshape(k, 6).astype(np.int32)
        want = np.asarray(JT.tree_gemm_scan(jnp.asarray(A), jnp.asarray(B),
                                            jplan, out))
        a, b = torch.from_numpy(A), torch.from_numpy(B)
        np.testing.assert_array_equal(
            TT.tree_gemm_plain(a, b, tplan, P(out)).numpy(), want)
        np.testing.assert_array_equal(
            TT.tree_gemm_stream_plain(a, b, tplan, P(out)).numpy(), want)


def test_tree_gemm_wrappers_take_the_pair_route_on_cpu():
    jplan, tplan = _pair_plan(F12, 100, layers=(qformat(14, 12),))
    rng = np.random.RandomState(4)
    A = _raws(rng, F12, 7 * 100).reshape(7, 100).astype(np.int32)
    B = _raws(rng, F12, 100 * 9).reshape(100, 9).astype(np.int32)
    want = np.asarray(JT.tree_gemm_scan(jnp.asarray(A), jnp.asarray(B),
                                        jplan, F12))
    a, b = torch.from_numpy(A), torch.from_numpy(B)
    TT.tree_gemm.launches = TT.tree_gemm_stream.launches = 0
    np.testing.assert_array_equal(TT.tree_gemm(a, b, tplan, P(F12)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        TT.tree_gemm_stream(a, b, tplan, P(F12)).numpy(), want)
    assert TT.tree_gemm.launches == TT.tree_gemm_stream.launches == 0


@pytest.mark.parametrize("rm,om", [(RoundMode.TRN_TCPL,
                                    OverflowMode.SAT_ZERO),
                                   (RoundMode.RND_CONV, OverflowMode.WRP_TCPL),
                                   (RoundMode.TRN_SMGN,
                                    OverflowMode.SAT_SMGN)],
                         ids=["canonical-modes", "conv-wrap", "smgn"])
def test_chain_probe_pair_route_matches_jax_chain(rm, om):
    fmt = QFormat(12, 12, True, rm, om)
    jplan, tplan = _pair_plan(fmt, 256)
    rng = np.random.RandomState(int(rm))
    x = _raws(rng, fmt, 16 * 32).reshape(16, 32).astype(np.int32)
    y = _raws(rng, fmt, 16 * 32).reshape(16, 32).astype(np.int32)
    v, yv = jnp.asarray(x), jnp.asarray(y)
    for _ in range(6):
        p = JT._product(jplan, v, yv)
        v = JT._merge(jplan, 0, p, p)
    got = CP.chain_probe(torch.from_numpy(x), torch.from_numpy(y), tplan, 6,
                         2)
    for g in range(2):
        np.testing.assert_array_equal(got[g].numpy(), np.asarray(v))


def test_pair_route_code_selects_no_compiled_entry():
    """The kernels see the route as a code (0 i32, 1 split, 2 pair): a
    pair plan writes 2, and no plan whose route differs from a compiled
    entry's takes it, even with the entry's very steps."""
    assert TT.ROUTES == {"i32": 0, "split": 1, "pair": 2}
    _, tplan = _pair_plan(F12, 64)
    assert list(TT._build_params(tplan, P(F12), 0))[0] == 2
    assert list(TT._kernel_params(tplan, P(F12), 4))[0] == 2
    assert TT.k2s_plan(tplan) == 0 and CP.p1_plan(tplan) == 0
    assert TT.k2_modes(tplan) == 2      # K2's modes and 64-bit product
    f88z = qformat(8, 8, overflow_mode=OverflowMode.SAT_ZERO)
    canon = TT.plan_tree(P(f88z), P(f88z), P(mul_merge(f88z, f88z)), (), 64,
                         P(f88z))
    assert TT.k2s_plan(canon) == CP.p1_plan(canon) == 1
    for route, code in TT.ROUTES.items():
        plan = dataclasses.replace(canon, prod_route=route)
        assert list(TT._build_params(plan, P(f88z), 0))[0] == code
        want = 1 if route == "split" else 0
        assert TT.k2s_plan(plan) == CP.p1_plan(plan) == want, route


# ---------------------------------------------------------------------------
# qgemul's pair tiers
# ---------------------------------------------------------------------------

F58 = qformat(5, 8)


@pytest.mark.parametrize("out", [qformat(23, 8), qformat(31, 16),
                                 qformat(12, 10, round_mode=RoundMode.RND_INF,
                                         overflow_mode=OverflowMode.SAT_ZERO)],
                         ids=["lane", "pair", "rounded-lane"])
def test_fast_gemm_wide_matches_jax(out):
    mul_to, adds = qformat(11, 16), (qformat(22, 16),)
    k = 200
    rng = np.random.RandomState(k)
    A = _raws(rng, F58, 6 * k).reshape(6, k)
    B = _raws(rng, F58, k * 5).reshape(k, 5)
    plan = TG.exact_plan(P(F58), P(F58), P(mul_to), P(adds), k)
    assert plan is not None and not TG._device_epilogue_ok(plan, P(out))
    assert TG.wide_dot_ok(qt.from_raw(A, P(F58), "cpu"),
                          qt.from_raw(B, P(F58), "cpu"), P(out), plan)
    want = JG.qgemul(JQ.from_raw(A, F58), JQ.from_raw(B, F58), out,
                     mul_to=mul_to, add_formats=adds, use_pallas=False)
    got = TG._fast_gemm_wide(qt.from_raw(A, P(F58), "cpu"),
                             qt.from_raw(B, P(F58), "cpu"), P(out), plan)
    _same(got, want)
    _same(qt.qgemul(qt.from_raw(A, P(F58), "cpu"),
                    qt.from_raw(B, P(F58), "cpu"), P(out), mul_to=P(mul_to),
                    add_formats=P(adds)), want)


def test_pair_dot_2d_segments_and_chunks():
    """Segment dots (every product in int32) and chunked int64 products
    (pair operands) give the exact dot."""
    rng = np.random.RandomState(2)
    a = rng.randint(-(1 << 13), 1 << 13, (4, 100))
    b = rng.randint(-(1 << 13), 1 << 13, (100, 3))
    want = (a.astype(object) @ b.astype(object)).astype(np.int64)
    iv = TG.fmt_interval(P(F58)) * TG.fmt_interval(P(F58))
    for x, y in ((a.astype(np.int16), b.astype(np.int16)),
                 (a.astype(np.int64), b.astype(np.int64))):
        got = TG.pair_dot_2d(torch.from_numpy(x), torch.from_numpy(y), iv)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["q16", "full-prec", "full-prec-odd",
                                  "pair-operands"])
def test_stream_gemm_wide_matches_jax(name):
    q16 = qformat(15, 16, round_mode=RoundMode.TRN_TCPL,
                  overflow_mode=OverflowMode.SAT_ZERO)
    f88 = qformat(8, 8)
    fa, fb, mul_to, adds, full, out, k = {
        "q16": (q16, q16, q16, (q16,), False, q16, 64),
        "full-prec": (f88, f88, None, (qformat(24, 16),), True, f88, 48),
        "full-prec-odd": (f88, f88, None, (qformat(24, 16),), True, f88, 77),
        "pair-operands": (qformat(20, 20), qformat(5, 4), qformat(25, 20),
                          (qformat(30, 20, round_mode=RoundMode.RND_CONV),),
                          False, qformat(20, 12), 40),
    }[name]
    rng = np.random.RandomState(k)
    A = _raws(rng, fa, 4 * k).reshape(4, k)
    B = _raws(rng, fb, k * 3).reshape(k, 3)
    kw = dict(mul_to=mul_to, add_formats=adds, mul_full_prec=full)
    ja, jb = JQ.from_raw(A, fa), JQ.from_raw(B, fb)
    ta, tb = qt.from_raw(A, P(fa), "cpu"), qt.from_raw(B, P(fb), "cpu")
    tkw = dict(mul_to=P(mul_to), add_formats=P(adds), mul_full_prec=full)
    assert TG._plan_of(ta, tb, P(out), *tkw.values()).tier == "layered"
    with JG.stream_gate(0):
        want = JG.qgemul(ja, jb, out, use_pallas=False, **kw)
    with TG.stream_gate(0):
        streamed = TG._stream_gemm_wide(ta, tb, P(out), *tkw.values())
        got = TG.qgemul(ta, tb, P(out), **tkw)
    assert streamed is not None
    _same(streamed, want)
    _same(got, want)
    # the layered path (gate closed) gives the same bits
    _same(TG.qgemul(ta, tb, P(out), **tkw), want)
