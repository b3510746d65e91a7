"""The torch port against golden vectors of the compiled C++ reference, Δ=0.

``tools/gen_golden.py`` compiled the reference header and recorded its
results in ``tests/golden_data/*.json``; ``tests/test_golden.py`` pins the
JAX package to them.  Here the same records pin the port on the CPU: the
converting copy (``requant.json``, skipping the reference's documented
defects with the port's ``hostint.reference_requant_defect``), the binary
ops (``mul``/``add``/``sub``), ``qabs``/``qneg`` (``unary``), ``qcmp``/
``qeq`` (``cmp``), ``qreduce`` (``reduce``, its vector entry point) and the
double constructor (``dbl``); and the converting copy's records again
through the 64-bit requantize of the pair route.  Lane and pair storage
are ported; a record whose operands, result or intermediates need limb or
host storage must raise ``NotImplementedError`` until ROADMAP A4 ports
them.  There is no ``div.json``.  This file imports no JAX.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import qublas_tpu_torch as qt
from qublas_tpu_torch import hostint
from qublas_tpu_torch.ops import elementwise as ew
from qublas_tpu_torch.ops.reduce import qreduce
from qublas_tpu_torch.ops.wideint import requantize_i64
from qublas_tpu_torch.ops.widths import (fmt_interval, route_addsub,
                                         route_mul,
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
    """The raws fit the format's lane or pair storage word."""
    dt = storage_dtype(fmt)
    if dt is None:
        return False
    word = 64 if storage_kind(fmt) == "pair" else 32
    return all(-(1 << (word - 1)) <= int(v) < (1 << (word - 1))
               for v in raws)


def _tensor(raws, fmt):
    return qt.from_raw(np.array([int(v) for v in raws], dtype=np.int64), fmt,
                       "cpu")


def _raws(t):
    return [int(v) for v in t.raw().reshape(-1)]


# ---------------------------------------------------------------------------
# requantize (the converting copy)
# ---------------------------------------------------------------------------

def _requant_needs_limbs(rec) -> bool:
    src, dst = _fmt(rec["from"]), _fmt(rec["to"])
    return not (_on_device(rec["in"], src)
                and storage_dtype(dst) is not None
                and route_requant(fmt_interval(src), src.frac_bits, dst)
                != "limb")


def test_requant_limb_records_are_counted():
    """21 of the 140 records need limb storage (or a limb requantize) and
    wait for ROADMAP A4; the other 119 are held Δ=0 below."""
    recs = _load("requant")
    assert len(recs) == 140
    assert sum(_requant_needs_limbs(r) for r in recs) == 21


@pytest.mark.parametrize("i", range(len(_load("requant"))),
                         ids=_ids("requant"))
def test_requant_golden(i):
    rec = _load("requant")[i]
    src, dst = _fmt(rec["from"]), _fmt(rec["to"])
    ins = [int(v) for v in rec["in"]]
    outs = [int(v) for v in rec["out"]]
    if _requant_needs_limbs(rec):
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            ew.qcast(_tensor(ins, src), dst)
        return
    got = ew.qcast(_tensor(ins, src), dst)
    assert got.fmt == dst
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
        route = route_mul(fa, fb, out)[0]
    else:
        out = add_merge(fa, fb, to)
        route = route_addsub(fa, fb, out, kind == "sub")[0]
    assert out == res_fmt
    op = {"mul": qt.qmul, "add": qt.qadd, "sub": qt.qsub}[kind]
    limbs = route == "limb" or storage_dtype(res_fmt) is None or not (
        _on_device(rec["ina"], fa) and _on_device(rec["inb"], fb))
    if limbs:
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            op(_tensor(rec["ina"], fa), _tensor(rec["inb"], fb), to=to)
        return
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
        if not _on_device(ins, fa) or not _on_device(want, res_fmt):
            with pytest.raises(NotImplementedError, match="ROADMAP A4"):
                op(_tensor(ins, fa))
            continue
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
    if storage_dtype(res_fmt) is None:
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            qreduce(x, layers)
        return
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
    if storage_dtype(f) is None:
        with pytest.raises(NotImplementedError, match="ROADMAP A4"):
            qt.from_float(np.array([float(d) for d in rec["in"]]), f, "cpu")
        return
    got = _raws(qt.from_float(np.array([float(d) for d in rec["in"]]), f,
                              "cpu"))
    for g, want, ok in zip(got, rec["out"], keep):
        if ok:  # else a documented defect (REFERENCE_DEFECTS.md D2/D3)
            assert g == int(want), (f, g, want)
