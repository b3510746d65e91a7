"""The torch port against golden vectors of the compiled C++ reference, Δ=0.

``tools/gen_golden.py`` compiled the reference header and recorded its
results in ``tests/golden_data/*.json``; ``tests/test_golden.py`` pins the
JAX package to them.  Here the same records pin the port on the CPU: the
converting copy (``requant.json``, skipping the reference's documented
defects with the port's ``hostint.reference_requant_defect``), the binary
ops (``mul``/``add``/``sub``), ``qabs``/``qneg`` (``unary``), ``qcmp``/
``qeq`` (``cmp``), ``qreduce`` (``reduce``, its vector entry point) and the
double constructor (``dbl``); the converting copy's lane records again
through the 64-bit requantize of the pair route; ANUS ``qpoly`` and
``qapprox`` (``qpoly``, ``qapprox``); and the reference's mt19937 streams,
``fill()`` draws of every storage width and the tensor ``shuffle()``
(``fill``, ``shuffle``, read as ``tests/test_refrand.py`` reads them).
Every golden file has a reader here.  Every storage kind is ported, so
every record computes, on whatever storage its operands and result take
(none needs host storage today).  There is no ``div.json``.  This file
imports no JAX.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu_torch import anus, hostint, refrand
from qublas_tpu_torch.ops import elementwise as ew
from qublas_tpu_torch.ops.reduce import qreduce
from qublas_tpu_torch.ops.wideint import requantize_i64
from qublas_tpu_torch.ops.widths import (fmt_interval, limb_count,
                                         route_requant, storage_dtype,
                                         storage_kind)
from qublas_tpu_torch.qformat import (OverflowMode, QFormat, RoundMode,
                                      add_merge, mul_merge)

DATA = pathlib.Path(__file__).parent / "golden_data"


def _load(kind):
    return json.loads((DATA / f"{kind}.json").read_text())


def _fmt(js) -> QFormat:
    i, f, s, rm, om = js
    return QFormat(i, f, bool(s), RoundMode(rm), OverflowMode(om))


def _ids(kind):
    return [f"{kind}{i}" for i in range(len(_load(kind)))]


def _on_device(raws, fmt) -> bool:
    """The raws fit the format's lane, pair or limb storage word."""
    kind = storage_kind(fmt)
    if kind is None:
        return False
    word = {"lane": 32, "pair": 64}.get(kind) or 32 * limb_count(fmt)
    return all(-(1 << (word - 1)) <= int(v) < (1 << (word - 1))
               for v in raws)


def _tensor(raws, fmt):
    return qt.from_raw(np.array([int(v) for v in raws], dtype=object), fmt,
                       "cpu")


def _raws(t):
    return [int(v) for v in t.raw().reshape(-1)]


# ---------------------------------------------------------------------------
# requantize (the converting copy)
# ---------------------------------------------------------------------------

def _requant_needs_limbs(rec) -> bool:
    """The record's source or destination has limb storage, or its
    requantize takes the limb route."""
    src, dst = _fmt(rec["from"]), _fmt(rec["to"])
    return "limb" in (storage_kind(src), storage_kind(dst),
                      route_requant(fmt_interval(src), src.frac_bits, dst))


def _requant_needs_host(rec) -> bool:
    src, dst = _fmt(rec["from"]), _fmt(rec["to"])
    return not _on_device(rec["in"], src) or storage_kind(dst) is None


def test_requant_limb_records_are_counted():
    """21 of the 140 records need limb storage (or a limb requantize), none
    host storage: all 140 are held Δ=0 below, the 119 lane ones through
    the 64-bit core too."""
    recs = _load("requant")
    assert len(recs) == 140
    assert sum(_requant_needs_limbs(r) for r in recs) == 21
    assert sum(_requant_needs_host(r) for r in recs) == 0


@pytest.mark.parametrize("i", range(len(_load("requant"))),
                         ids=_ids("requant"))
def test_requant_golden(i):
    rec = _load("requant")[i]
    src, dst = _fmt(rec["from"]), _fmt(rec["to"])
    ins = [int(v) for v in rec["in"]]
    outs = [int(v) for v in rec["out"]]
    got = ew.qcast(_tensor(ins, src), dst)
    assert got.fmt == dst
    assert got.is_limb == (storage_kind(dst) == "limb")
    keep = [not hostint.reference_requant_defect(x, src, dst) for x in ins]
    assert sum(keep) > 0
    for x, g, want, ok in zip(ins, _raws(got), outs, keep):
        if ok:  # else a documented defect (REFERENCE_DEFECTS.md D2/D3)
            assert g == want, (src, dst, x, g, want)


_LANE = [i for i, r in enumerate(_load("requant"))
         if not _requant_needs_limbs(r)]


@pytest.mark.parametrize("i", _LANE, ids=[f"requant{i}" for i in _LANE])
def test_requant_golden_through_the_int64_core(i):
    """The same records through ``requantize_i64``, the 64-bit requantize
    that the pair route runs (here on values that fit a lane), narrowed to
    the destination's storage as the pair route's results are."""
    rec = _load("requant")[i]
    src, dst = _fmt(rec["from"]), _fmt(rec["to"])
    ins = [int(v) for v in rec["in"]]
    got = requantize_i64(torch.tensor(ins, dtype=torch.int64),
                         src.frac_bits, dst).to(storage_dtype(dst))
    for x, g, want in zip(ins, got.tolist(), rec["out"]):
        if not hostint.reference_requant_defect(x, src, dst):
            assert g == int(want), (src, dst, x, g, want)


# ---------------------------------------------------------------------------
# binary ops, unary ops, compares
# ---------------------------------------------------------------------------

_BINARY = [(kind, i) for kind in ("mul", "add", "sub")
           for i in range(len(_load(kind)))]


@pytest.mark.parametrize("kind,i", _BINARY,
                         ids=[f"{k}{i}" for k, i in _BINARY])
def test_binary_op_golden(kind, i):
    rec = _load(kind)[i]
    fa, fb = _fmt(rec["a"]), _fmt(rec["b"])
    to = None if rec["to"] is None else _fmt(rec["to"])
    res_fmt = _fmt(rec["res_fmt"])
    if kind == "mul":
        out = mul_merge(fa, fb, to)
    else:
        out = add_merge(fa, fb, to)
    assert out == res_fmt
    op = {"mul": qt.qmul, "add": qt.qadd, "sub": qt.qsub}[kind]
    got = op(_tensor(rec["ina"], fa), _tensor(rec["inb"], fb), to=to)
    assert got.fmt == res_fmt
    assert _raws(got) == [int(v) for v in rec["out"]], (kind, fa, fb, to)


@pytest.mark.parametrize("i", range(len(_load("unary"))),
                         ids=_ids("unary"))
def test_unary_golden(i):
    rec = _load("unary")[i]
    fa = _fmt(rec["a"])
    ins = [int(v) for v in rec["in"]]
    for op, key in ((qt.qabs, "abs"), (qt.qneg, "neg")):
        res_fmt = _fmt(rec[f"{key}_fmt"])
        want = [int(v) for v in rec[key]]
        got = op(_tensor(ins, fa))
        if fa.signed or key == "neg":
            assert got.fmt == res_fmt, (key, fa)
        assert _raws(got) == want, (key, fa)


@pytest.mark.parametrize("i", range(len(_load("cmp"))), ids=_ids("cmp"))
def test_cmp_golden(i):
    rec = _load("cmp")[i]
    fa, fb = _fmt(rec["a"]), _fmt(rec["b"])
    a, b = _tensor(rec["ina"], fa), _tensor(rec["inb"], fb)
    assert [int(v) for v in qt.qcmp(a, b)] == [int(v) for v in rec["cmp"]]
    assert [int(v) for v in qt.qeq(a, b)] == [int(v) for v in rec["eq"]]


# ---------------------------------------------------------------------------
# reduce and the double constructor
# ---------------------------------------------------------------------------

_VEC = [i for i, r in enumerate(_load("reduce")) if r["variant"] == "vec"]


@pytest.mark.parametrize("i", _VEC, ids=[f"reduce{i}" for i in _VEC])
def test_reduce_golden(i):
    rec = _load("reduce")[i]
    elem = _fmt(rec["elem"])
    layers = tuple(_fmt(l) for l in rec["layers"])
    res_fmt = _fmt(rec["res_fmt"])
    x = _tensor(rec["in"], elem)
    got = qreduce(x, layers)
    assert got.fmt == res_fmt
    assert int(got.raw()) == int(rec["out"])


@pytest.mark.parametrize("i", range(len(_load("dbl"))), ids=_ids("dbl"))
def test_double_to_fixed_golden(i):
    rec = _load("dbl")[i]
    f = _fmt(rec["fmt"])
    keep = [not hostint.reference_double_ctor_defect(float(d), f)
            for d in rec["in"]]
    assert any(keep)
    got = _raws(qt.from_float(np.array([float(d) for d in rec["in"]]), f,
                              "cpu"))
    for g, want, ok in zip(got, rec["out"], keep):
        if ok:  # else a documented defect (REFERENCE_DEFECTS.md D2/D3)
            assert g == int(want), (f, g, want)


# ---------------------------------------------------------------------------
# ANUS and the reference's random streams
# ---------------------------------------------------------------------------

def test_qpoly_golden():
    for rec in _load("qpoly"):
        f = _fmt(rec["fmt"])
        coeffs = [qt.from_raw(np.array(int(c), dtype=object), f, "cpu")
                  for c in rec["coeffs"]]
        got = anus.qpoly(_tensor(rec["in"], f), coeffs)
        assert _raws(got) == [int(v) for v in rec["out"]]


def test_qapprox_golden():
    for rec in _load("qapprox"):
        f = _fmt(rec["fmt"])
        c = [qt.scalar(v, f, "cpu") for v in (1.0, 0.5, -1.0, 2.0)]
        segs = [anus.Segment(0.0, c[:2]), anus.Segment(1.0, c[2:])]
        got = anus.qapprox(_tensor(rec["in"], f), segs)
        assert got.fmt == f
        assert _raws(got) == [int(v) for v in rec["out"]]


@pytest.mark.parametrize("i", range(len(_load("fill"))),
                         ids=[f"w{r['w']}" for r in _load("fill")])
def test_fill_golden(i):
    """mt19937 seed 1 and libstdc++'s uniform_int_distribution, drawn one
    raw at a time and as a tensor of a format of that storage width (lane,
    pair or limb storage)."""
    rec = _load("fill")[i]
    want = [int(v) for v in rec["out"]]
    gen = refrand.MT19937(1)
    assert [refrand.fill_raw(gen, rec["w"]) for _ in want] == want
    f = QFormat(rec["w"] - 1, 0)
    assert f.storage_bits == rec["w"]
    t = refrand.reference_fill((len(want),), f, gen=refrand.MT19937(1),
                               device="cpu")
    assert _raws(t) == want


@pytest.mark.parametrize("i", range(len(_load("shuffle"))),
                         ids=[f"n{r['n']}" for r in _load("shuffle")])
def test_shuffle_golden(i):
    """std::shuffle(gen) of raws 1000..1000+n-1 from a fresh seed-1
    stream."""
    rec = _load("shuffle")[i]
    src = np.arange(1000, 1000 + rec["n"])
    got = refrand.reference_shuffle(qt.from_raw(src, QFormat(8, 8), "cpu"),
                                    gen=refrand.MT19937(1))
    assert _raws(got) == [int(v) for v in rec["out"]]
