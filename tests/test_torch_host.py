"""The port's host storage against the JAX package's ``is_host`` paths, Δ=0.

Host storage holds what no device storage can: formats beyond 992 bits
and ``fill(int)`` wart raws beyond the storage word of a lane, pair or
limb format, as numpy object arrays of Python ints.  Each ported host
route takes the same numpy raws as the JAX package and must give the same
raws, format and storage kind: the constructors, every elementwise op
(the native engine's and the per-element model's), ``qreduce``,
``QTable``, ``qpoly``/``qapprox``, the host GEMM (native and Python) with
``qgemv`` and batches, ``cgemul`` with host parts, ``bitstream``,
``bitwise``, ``requant_stats``, ``refrand`` and checkpoints both ways.
A host result that fits device storage lands on the device of the first
operand with device storage, else on the host operand's own device.
Shapes stay tiny: every element is a Python int.
"""

import dataclasses

import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu import anus as JA
from qublas_tpu import bitstream as JB
from qublas_tpu import bitwise as JW
from qublas_tpu import checkpoint as JC
from qublas_tpu import complex as JX
from qublas_tpu import diagnostics as JD
from qublas_tpu import qtensor as JQ
from qublas_tpu import refrand as JR
from qublas_tpu.ops import cgemm as JCG
from qublas_tpu.ops import elementwise as JE
from qublas_tpu.ops import gemm as JG
from qublas_tpu.ops import reduce as JRD
from qublas_tpu.qformat import OverflowMode, RoundMode, qformat
from qublas_tpu_torch import bitwise as TW
from qublas_tpu_torch import checkpoint as TC
from qublas_tpu_torch import diagnostics as TD
from qublas_tpu_torch import refrand as TR
from qublas_tpu_torch.convert import port_format as P
from qublas_tpu_torch.ops import gemm as TG

CPU = torch.device("cpu")
H600 = qformat(600, 600)                 # 1,201-bit storage
H1000 = qformat(1000, 3, round_mode=RoundMode.RND_CONV,
                overflow_mode=OverflowMode.SAT_ZERO)
H4200 = qformat(4200, 0)                 # products beyond the engine
F34 = qformat(3, 4)
W40 = qformat(40, 0)                     # pair storage
W70 = qformat(70, 10)                    # limb storage


def _wide(rng, fmt, shape):
    """Raws over the whole range of a format of any width, edges first."""
    span = fmt.raw_max - fmt.raw_min + 1
    n = int(np.prod(shape))
    vals = [fmt.raw_min, fmt.raw_max, 0, -1, 1][:n]
    while len(vals) < n:
        v = 0
        for _ in range(fmt.storage_bits // 62 + 2):
            v = (v << 62) | int(rng.randint(0, 1 << 62))
        vals.append(fmt.raw_min + v % span)
    return np.array(vals, dtype=object).reshape(shape)


def _wart(rng, fmt, shape, bits):
    """Raws of ``fmt`` with some beyond a ``bits``-bit word."""
    raws = _wide(rng, fmt, shape).reshape(-1)
    raws[::3] = [int(v) + (1 << bits) for v in raws[::3]]
    return raws.reshape(shape)


def _both(raws, fmt):
    return JQ.from_raw(raws, fmt), qt.from_raw(raws, P(fmt), CPU)


def _same(got, want):
    """Port QTensor == JAX QTensor: format fields, storage kind, raws."""
    assert dataclasses.astuple(got.fmt) == dataclasses.astuple(want.fmt)
    assert (got.is_host, got.is_limb, got.is_pair) == \
        (want.is_host, want.is_limb, want.is_pair)
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(np.asarray(got.raw(), dtype=object),
                                  np.asarray(want.raw(), dtype=object))
    if not got.is_host:
        assert got.device == CPU


def _p(v):
    """A JAX format, or a tuple of them, as the port's."""
    if isinstance(v, tuple):
        return tuple(P(f) for f in v)
    return P(v) if isinstance(v, type(H600)) else v


def _tk(kw):
    return {k: _p(v) for k, v in kw.items()}


# ---------------------------------------------------------------------------
# storage and constructors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,bits", [(F34, 32), (W40, 64), (W70, 96),
                                      (H600, None)],
                         ids=["lane-wart", "pair-wart", "limb-wart", "1201"])
def test_from_raw_takes_host_storage_where_jax_does(fmt, bits):
    rng = np.random.RandomState(1)
    raws = _wide(rng, fmt, (3, 4)) if bits is None \
        else _wart(rng, fmt, (3, 4), bits)
    j, t = _both(raws, fmt)
    assert t.is_host and j.is_host
    _same(t, j)
    np.testing.assert_array_equal(t.to_double(), j.to_double())
    _same(t[1], j[1])
    _same(t[1, 2:], j[1, 2:])
    _same(t.shuffle(3), j.shuffle(3))
    assert t.device == CPU and t.to("cuda").device.type == "cuda"


def test_host_tensor_device_defaults_to_the_card():
    """A host tensor built without a device names the card as its
    results' device, as ``from_raw`` does for device storage."""
    t = qt.from_raw([1 << 1000], P(H600))
    assert t.is_host and t.device.type == "cuda"
    assert qt.zeros((2,), P(H600)).device.type == "cuda"


def test_zeros_random_fill_from_float_match_jax():
    _same(qt.zeros((2, 3), P(H600), CPU), JQ.zeros((2, 3), H600))
    _same(qt.random_fill((5,), P(H1000), 4, CPU),
          JQ.random_fill((5,), H1000, 4))
    vals = np.array([0.0, -1.5, 3.25, 1e30, -2.0 ** 70, np.nan, 1e-9, 7e-301])
    for f in (H600, H1000, F34, qformat(30, 33),
              qformat(8, 8, overflow_mode=OverflowMode.WRP_TCPL)):
        _same(qt.from_float(vals, P(f), CPU), JQ.from_float(vals, f))


# ---------------------------------------------------------------------------
# elementwise ops
# ---------------------------------------------------------------------------

BINARY = ["qmul", "qadd", "qsub", "qdiv"]
CASES = {
    # two 1,201-bit operands (the native multiword engine)
    "host-host": (H600, H600, None),
    # a 2,000-bit result on the engine's 2,048-bit width
    "wide-result": (H1000, H1000, qformat(1999, 3)),
    # an 8,401-bit result: beyond the engine, the Python model
    "beyond-engine": (H4200, H4200, qformat(8400, 0)),
    # a host operand against a lane one, into a lane result
    "host-lane": (H600, F34, F34),
    # wart raws of a lane format against a pair operand
    "wart-pair": ("wart", W40, qformat(20, 4)),
}


def _operands(name, seed):
    fa, fb, to = CASES[name]
    rng = np.random.RandomState(seed)
    if fa == "wart":
        fa = F34
        ja, ta = _both(_wart(rng, F34, (2, 3), 32), F34)
    else:
        ja, ta = _both(_wide(rng, fa, (2, 3)), fa)
    jb, tb = _both(_wide(rng, fb, (2, 3)), fb)
    return (ja, jb), (ta, tb), to


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("op", BINARY)
def test_binary_ops_match_jax(op, case):
    (ja, jb), (ta, tb), to = _operands(case, BINARY.index(op))
    kw = {} if to is None else {"to": to}
    _same(getattr(qt, op)(ta, tb, **_tk(kw)), getattr(JE, op)(ja, jb, **kw))
    _same(getattr(qt, op)(tb, ta, **_tk(kw)), getattr(JE, op)(jb, ja, **kw))


@pytest.mark.parametrize("rm,om", [(RoundMode.RND_CONV, OverflowMode.SAT_ZERO),
                                   (RoundMode.TRN_SMGN, OverflowMode.WRP_TCPL),
                                   (RoundMode.RND_INF, OverflowMode.SAT_SMGN)])
def test_modes_unary_compare_cast_match_jax(rm, om):
    rng = np.random.RandomState(int(rm) + 10 * int(om))
    f = qformat(700, 300, round_mode=rm, overflow_mode=om)
    ja, ta = _both(_wide(rng, f, (4,)), f)
    jb, tb = _both(_wide(rng, f, (4,)), f)
    to = qformat(650, 200, round_mode=rm, overflow_mode=om)
    for op in BINARY:
        _same(getattr(qt, op)(ta, tb, to=P(to)),
              getattr(JE, op)(ja, jb, to=to))
    for op in ("qabs", "qneg"):
        _same(getattr(qt, op)(ta), getattr(JE, op)(ja))
    for op in ("qcmp", "qeq"):
        got = getattr(qt, op)(ta, tb)
        assert got.device == CPU
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(JE, op)(ja, jb)))
    for dst in (F34, W40, W70, qformat(1100, 2, round_mode=rm)):
        _same(qt.qcast(ta, P(dst)), JE.qcast(ja, dst))
    _same(ta.astype(P(f)), ja.astype(f))


def test_host_results_land_on_the_device_operands_device():
    """A host op whose result fits device storage puts it on the device of
    the operand with device storage."""
    ta = qt.from_raw([1 << 1000, 5], P(H600))          # results to the card
    tb = qt.from_raw([1, 2], P(F34), CPU)
    got = qt.qmul(ta, tb, to=P(F34))
    assert not got.is_host and got.device == CPU
    assert qt.qcmp(tb, ta).device == CPU


# ---------------------------------------------------------------------------
# qreduce, QTable, ANUS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers,axis", [((), None), ((H1000,), 0),
                                         ((qformat(610, 590), F34), 1)])
def test_qreduce_of_and_into_host_matches_jax(layers, axis):
    rng = np.random.RandomState(7)
    ja, ta = _both(_wide(rng, H600, (3, 5)), H600)
    _same(qt.qreduce(ta, _p(layers), axis=axis),
          JRD.qreduce(ja, layers, axis=axis))
    # lane operands with wart raws, into a host layer format
    jw, tw = _both(_wart(rng, F34, (4, 3), 32), F34)
    _same(qt.qreduce(tw, (P(H600),), axis=0), JRD.qreduce(jw, (H600,), axis=0))


def test_qtable_into_and_from_host_matches_jax():
    x = np.arange(-128, 128).reshape(16, 16)
    for out in (H600, H1000):
        jt, tt = JA.QTable(JA.sqrt_func, F34, out), \
            qt.QTable(qt.sqrt_func, P(F34), P(out))
        _same(tt(qt.from_raw(x, P(F34), CPU)), jt(JQ.from_raw(x, F34)))
    # wart raws into lane, pair and limb tables: read back for the lookup
    jw, tw = _both(_wart(np.random.RandomState(2), F34, (3, 3), 32), F34)
    for out in (qformat(6, 6), qformat(20, 20), qformat(70, 70)):
        _same(qt.QTable(qt.rsqrt_func, P(F34), P(out))(tw),
              JA.QTable(JA.rsqrt_func, F34, out)(jw))


def test_qpoly_qapprox_on_host_match_jax():
    rng = np.random.RandomState(8)
    jx, tx = _both(_wide(rng, H600, (6,)), H600)
    fc = qformat(620, 590)
    coef = [0.75, -1.5, 0.25]
    jc = [JQ.scalar(v, fc) for v in coef]
    tc = [qt.scalar(v, P(fc), CPU) for v in coef]
    _same(qt.qpoly(tx, tc), JA.qpoly(jx, jc))
    jsegs = [JA.Segment(-1e100, jc[:1]), JA.Segment(0.0, jc[:2]),
             JA.Segment(1e50, jc)]
    tsegs = [qt.Segment(-1e100, tc[:1]), qt.Segment(0.0, tc[:2]),
             qt.Segment(1e50, tc)]
    _same(qt.qapprox(tx, tsegs), JA.qapprox(jx, jsegs))


# ---------------------------------------------------------------------------
# the host GEMM
# ---------------------------------------------------------------------------

def _spy_native(monkeypatch):
    from qublas_tpu_torch import native

    seen = []
    fn = native.tree_gemm_host

    def spy(*args, **kw):
        res = fn(*args, **kw)
        seen.append(res is not None)
        return res

    monkeypatch.setattr(native, "tree_gemm_host", spy)
    return seen


@pytest.mark.parametrize("case", ["native-wart", "native-1201", "python",
                                  "transposed"])
def test_host_gemm_matches_jax(case, monkeypatch):
    """2-D host operands on the native tree GEMM (a 64-bit format's wart
    raws; 1,201-bit operands on the multiword engine) and on the Python
    model (an 8,401-bit product is beyond the engine), transposed too."""
    rng = np.random.RandomState(11)
    if case == "native-wart":
        f, kw, out = qformat(31, 0), dict(mul_to=qformat(40, 0)), W40
        A, B = _wart(rng, f, (3, 5), 64), _wide(rng, f, (5, 2))
    elif case in ("native-1201", "transposed"):
        f, kw, out = H600, dict(add_formats=(qformat(601, 600),)), H600
        A, B = _wide(rng, f, (3, 5)), _wide(rng, f, (5, 2))
    else:
        f, kw, out = H4200, dict(mul_full_prec=True), H1000
        A, B = _wide(rng, f, (2, 3)), _wide(rng, f, (3, 2))
    tr = case == "transposed"
    if tr:
        A, B = np.ascontiguousarray(A.T), np.ascontiguousarray(B.T)
    seen = _spy_native(monkeypatch)
    got = qt.qgemul(qt.from_raw(A, P(f), CPU), qt.from_raw(B, P(f), CPU),
                    P(out), transpose_a=tr, transpose_b=tr, **_tk(kw))
    assert seen == [case != "python"]
    want = JG.qgemul(JQ.from_raw(A, f), JQ.from_raw(B, f), out,
                     transpose_a=tr, transpose_b=tr, **kw)
    _same(got, want)
    np.testing.assert_array_equal(
        np.asarray(got.raw(), dtype=object),
        TG.host_qgemul(qt.from_raw(A.T if tr else A, P(f), CPU),
                       qt.from_raw(B.T if tr else B, P(f), CPU), P(out),
                       **_tk(kw)))


def test_batched_host_gemm_and_qgemv_match_jax():
    rng = np.random.RandomState(12)
    f = H600
    A, B = _wide(rng, f, (2, 2, 3)), _wide(rng, f, (3, 2))
    got = qt.qgemul(qt.from_raw(A, P(f), CPU), qt.from_raw(B, P(f), CPU),
                    P(f))
    _same(got, JG.qgemul(JQ.from_raw(A, f), JQ.from_raw(B, f), f))
    x = _wide(rng, f, (3,))
    _same(qt.qgemv(qt.from_raw(B.T.copy(), P(f), CPU),
                   qt.from_raw(x, P(f), CPU), P(f)),
          JG.qgemv(JQ.from_raw(B.T.copy(), f), JQ.from_raw(x, f), f))


def test_products_beyond_device_storage_take_the_host_gemm():
    """Limb operands whose products need host storage: the layered path
    hands the GEMM to the host model, as the JAX package's does."""
    rng = np.random.RandomState(13)
    f = qformat(600, 300)
    A, B = _wide(rng, f, (2, 3)), _wide(rng, f, (3, 2))
    ja, ta = _both(A, f)
    jb, tb = _both(B, f)
    assert ta.is_limb
    _same(qt.qgemul(ta, tb, P(H1000), mul_full_prec=True),
          JG.qgemul(ja, jb, H1000, mul_full_prec=True))


@pytest.mark.parametrize("algo", ["basic", "tf"])
def test_cgemul_with_host_parts_matches_jax(algo):
    rng = np.random.RandomState(14)
    f = H600
    raws = [_wide(rng, f, s) for s in ((2, 3), (2, 3), (3, 2), (3, 2))]
    ja = JX.complex_from_raw(raws[0], raws[1], f)
    jb = JX.complex_from_raw(raws[2], raws[3], f)
    ta = qt.complex_from_raw(raws[0], raws[1], P(f), device=CPU)
    tb = qt.complex_from_raw(raws[2], raws[3], P(f), device=CPU)
    got = qt.cgemul(ta, tb, P(f), algo=algo)
    want = JCG.cgemul(ja, jb, f, algo=algo)
    _same(got.real, want.real)
    _same(got.imag, want.imag)


# ---------------------------------------------------------------------------
# bitstream, bitwise, diagnostics, refrand, checkpoints
# ---------------------------------------------------------------------------

def test_bitstream_of_host_tensors_matches_jax():
    rng = np.random.RandomState(15)
    for f, raws in ((H600, _wide(rng, H600, (2, 3))),
                    (F34, _wart(rng, F34, (2, 3), 32)),
                    (qformat(30, 33), _wart(rng, qformat(30, 33), (2, 3),
                                            64))):
        j, t = _both(raws, f)
        bits = JB.to_bits(j)
        assert qt.bitstream.to_bits(t) == bits
        _same(qt.bitstream.from_bits(bits, P(f), (2, 3),
                                     twos_complement=True, device=CPU),
              JB.from_bits(bits, f, (2, 3), twos_complement=True))


def test_bitwise_diagnostics_refrand_on_host_match_jax():
    rng = np.random.RandomState(16)
    ja, ta = _both(_wide(rng, H600, (2, 3)), H600)
    jw, tw = _both(_wart(rng, F34, (2, 3), 32), F34)
    for op in ("qand", "qor", "qxor"):
        _same(getattr(TW, op)(ta, tw), getattr(JW, op)(ja, jw))
    _same(TW.qnot(ta), JW.qnot(ja))
    _same(TW.qnot(tw), JW.qnot(jw))
    for dst in (F34, qformat(500, 100, round_mode=RoundMode.RND_CONV)):
        for jt, tt in ((ja, ta), (jw, tw)):
            assert tuple(int(v) for v in TD.requant_stats(tt, P(dst))) == \
                tuple(int(v) for v in JD.requant_stats(jt, dst))
    _same(TR.reference_fill((2, 2), P(H600), TR.MT19937(3), device=CPU),
          JR.reference_fill((2, 2), H600, JR.MT19937(3)))
    _same(TR.reference_shuffle(ta, TR.MT19937(4)),
          JR.reference_shuffle(ja, JR.MT19937(4)))


def test_checkpoints_of_host_tensors_cross_both_ways(tmp_path):
    rng = np.random.RandomState(17)
    ja, ta = _both(_wide(rng, H600, (2, 3)), H600)
    jw, tw = _both(_wart(rng, F34, (3,), 32), F34)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    JC.save(pj, {"h": ja, "w": [jw]})
    TC.save(pt, {"h": ta, "w": [tw]})
    got = TC.load(pj, device=CPU)
    _same(got["h"], ja)
    _same(got["w"][0], jw)
    back = JC.load(pt)
    _same(ta, back["h"])
    _same(tw, back["w"][0])
