"""Elementwise quantized ops on torch (Qmul/Qadd/Qsub/Qdiv/Qabs/Qneg/Qcmp/
Qeq and the converting cast).

Port of ``qublas_tpu/ops/elementwise.py`` for lane and pair storage.  Each
op is a short torch program — exact widened arithmetic, then the round ->
overflow epilogue of :mod:`.wideint` — chosen per op configuration by the
width proofs of :mod:`.widths`, before any data is touched:

* ``i32`` (and ``split`` for a product wider than int32): int32 lanes;
* ``pair``: int64 tensors, the JAX package's emulated (hi, lo) pairs, into
  a lane or a pair-storage result;
* ``host`` with a lane or pair result: the exact golden model
  (:mod:`..hostops`), one Python int per element;
* ``limb``, and results that need limb or host storage: not yet ported
  (ROADMAP A4), they raise.

All of them run on the tensors' own device.  They are plain torch ops on
the card too: the JAX package runs them as XLA ops, not as Pallas kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import hostops
from ..qformat import QFormat, add_merge, mul_merge
from ..qtensor import QTensor, from_float, from_raw
from .wideint import (
    _overflow_i32,
    div_trunc_i64,
    mul_wide,
    requantize_i32,
    requantize_i64,
    requantize_split_mul,
)
from .widths import (
    LIMB_INTER_MAX_BITS,
    Interval,
    fmt_interval,
    route_addsub,
    route_div,
    route_mul,
    route_requant,
    storage_dtype,
    storage_kind,
)

__all__ = ["qmul", "qadd", "qsub", "qdiv", "qabs", "qneg", "qcmp", "qeq",
           "qcast"]

I32_MIN = -(1 << 31)


def _unported(op: str, route: str):
    return NotImplementedError(
        f"{op}: the {route!r} route is not yet ported (ROADMAP A4)")


def _coerce_pair(a, b):
    if not isinstance(a, QTensor) and isinstance(b, QTensor):
        a = from_float(a, b.fmt, b.device)
    if not isinstance(b, QTensor) and isinstance(a, QTensor):
        b = from_float(b, a.fmt, a.device)
    if not (isinstance(a, QTensor) and isinstance(b, QTensor)):
        raise TypeError("elementwise ops need at least one QTensor operand")
    return a, b


def _host_binary(fn, a: QTensor, b: QTensor, **kw) -> QTensor:
    """``fn`` of the golden model per element, for a lane or pair result."""
    _, out_fmt = fn((0, a.fmt), (0, b.fmt), **kw)
    if storage_dtype(out_fmt) is None:
        raise _unported(fn.__name__, "host")
    A, B = np.broadcast_arrays(a.raw().astype(object), b.raw().astype(object))
    raws = [fn((int(x), a.fmt), (int(y), b.fmt), **kw)[0]
            for x, y in zip(A.reshape(-1), B.reshape(-1))]
    return from_raw(np.array(raws, dtype=np.int64).reshape(A.shape), out_fmt,
                    a.device)


def _host_unary(name: str, fn, a: QTensor) -> QTensor:
    _, out_fmt = fn((0, a.fmt))
    if storage_dtype(out_fmt) is None:
        raise _unported(name, "host")
    raws = [fn((int(x), a.fmt))[0] for x in a.raw().reshape(-1)]
    return from_raw(np.array(raws, dtype=np.int64).reshape(a.shape), out_fmt,
                    a.device)


def _finish(raw: torch.Tensor, out_fmt: QFormat) -> QTensor:
    """Store a result in the format's storage: an int32 or int64 result
    narrowed to its lane (wrapping, as the JAX package's ``astype`` and
    ``pair_to_int32`` do), or int64 for pair storage."""
    return QTensor(raw.to(storage_dtype(out_fmt)), out_fmt)


def _i32(t: QTensor) -> torch.Tensor:
    """Load as int32 lanes (the route proved that the values fit)."""
    return t.data.to(torch.int32)


def _i64(t: QTensor) -> torch.Tensor:
    """Load any device storage as int64 (the JAX package's ``_load_pair``)."""
    return t.data.to(torch.int64)


def qmul(a, b, to=None, full_prec: bool = False) -> QTensor:
    """Quantized multiply: exact product -> round -> saturate
    (QuBLAS.h:3146-3171)."""
    a, b = _coerce_pair(a, b)
    out = mul_merge(a.fmt, b.fmt, to, full_prec)
    route, _, from_frac = route_mul(a.fmt, b.fmt, out)
    if route == "host":
        return _host_binary(hostops.qmul, a, b, to=to, full_prec=full_prec)
    if route == "i32":
        raw = requantize_i32(_i32(a) * _i32(b), from_frac, out)
    elif route == "split":
        raw = requantize_split_mul(_i32(a), _i32(b), from_frac, out)
    elif route == "pair":
        raw = requantize_i64(mul_wide(a.data, b.data), from_frac, out)
    else:
        raise _unported("qmul", route)
    return _finish(raw, out)


def _addsub(a, b, to, full_prec, sub: bool) -> QTensor:
    a, b = _coerce_pair(a, b)
    out = add_merge(a.fmt, b.fmt, to, full_prec)
    route, _, f, _, _ = route_addsub(a.fmt, b.fmt, out, sub)
    if route == "host":
        return _host_binary(hostops.qsub if sub else hostops.qadd, a, b,
                            to=to, full_prec=full_prec)
    if route == "i32":
        load, requant = _i32, requantize_i32
    elif route == "pair":
        load, requant = _i64, requantize_i64
    else:
        raise _unported("qsub" if sub else "qadd", route)
    x = load(a) << (f - a.fmt.frac_bits)
    y = load(b) << (f - b.fmt.frac_bits)
    return _finish(requant(x - y if sub else x + y, f, out), out)


def qadd(a, b, to=None, full_prec: bool = False) -> QTensor:
    """Quantized add (QuBLAS.h:3177-3204)."""
    return _addsub(a, b, to, full_prec, sub=False)


def qsub(a, b, to=None, full_prec: bool = False) -> QTensor:
    """Quantized subtract (QuBLAS.h:3210-3235)."""
    return _addsub(a, b, to, full_prec, sub=True)


def qdiv(a, b, to=None, full_prec: bool = False) -> QTensor:
    """Quantized divide (QuBLAS.h:3241-3266).  Replicated reference warts:
    division by zero yields 0; the quotient truncates toward zero with no
    rounding stage, only the overflow stage."""
    a, b = _coerce_pair(a, b)
    out = add_merge(a.fmt, b.fmt, to, full_prec)
    route, _, _ = route_div(a.fmt, b.fmt, out)
    if route == "host":
        return _host_binary(hostops.qdiv, a, b, to=to, full_prec=full_prec)
    sb = max(a.fmt.frac_bits - b.fmt.frac_bits, 0)
    s = max(b.fmt.frac_bits - a.fmt.frac_bits, 0) + out.frac_bits
    if route == "pair":
        # no frac stage (d == 0 at out.frac_bits): overflow stage only
        q = div_trunc_i64(_i64(a) << s, _i64(b) << sb)
        return _finish(requantize_i64(q, out.frac_bits, out), out)
    if route != "i32":
        raise _unported("qdiv", route)
    x, y = _i32(a), _i32(b)
    num = x << s
    den = y << sb
    # den == 0 -> 0 (the wart); INT32_MIN / -1 (only reachable from raws
    # outside their format) wraps to INT32_MIN as on the XLA lanes, where
    # torch's CPU divide would trap
    trap = (num == I32_MIN) & (den == -1)
    q = torch.div(num, torch.where((den == 0) | trap, 1, den),
                  rounding_mode="trunc")
    q = torch.where(den == 0, 0, q)
    return _finish(_overflow_i32(q, out), out)


def _neg_out(fmt: QFormat) -> QFormat:
    return QFormat(fmt.int_bits + 1, fmt.frac_bits, fmt.signed,
                   fmt.round_mode, fmt.overflow_mode)


def _neg_load(fmt: QFormat, out: QFormat):
    """The loader whose words hold every raw of ``fmt`` and its negation:
    int32 lanes (guarding -INT32_MIN) for a lane result, int64 (within the
    pair margin) for a pair result, whose word then holds the exact
    negation (the golden model never wraps it); None for the host."""
    iv = fmt_interval(fmt)
    neg = Interval(-iv.hi, -iv.lo)
    kind = storage_kind(out)
    if iv.fits32 and neg.fits32 and kind == "lane":
        return _i32
    if iv.fits64 and neg.fits64 and kind == "pair" \
            and max(iv.bits, neg.bits) <= 64:
        return _i64
    return None


def qabs(a: QTensor) -> QTensor:
    """Absolute value (QuBLAS.h:3273-3300): unsigned is identity; signed
    widens int_bits by one, no requantization."""
    if not a.fmt.signed:
        return a
    out = _neg_out(a.fmt)
    load = _neg_load(a.fmt, out)
    if load is None:
        return _host_unary("qabs", hostops.qabs, a)
    x = load(a)
    return _finish(torch.where(x < 0, -x, x), out)


def qneg(a: QTensor) -> QTensor:
    """Negation (QuBLAS.h:3307-3317): widens int_bits by one."""
    out = _neg_out(a.fmt)
    load = _neg_load(a.fmt, out)
    if load is None:
        return _host_unary("qneg", hostops.qneg, a)
    return _finish(-load(a), out)


def _aligned(op: str, a: QTensor, b: QTensor):
    """Both operands at the common fractional scale on int32 lanes or, when
    a lane cannot hold them, on int64; None when only the host can align
    them."""
    f = max(a.fmt.frac_bits, b.fmt.frac_bits)
    sa, sb = f - a.fmt.frac_bits, f - b.fmt.frac_bits
    ia = fmt_interval(a.fmt) << sa
    ib = fmt_interval(b.fmt) << sb
    if max(ia.bits, ib.bits) > LIMB_INTER_MAX_BITS:
        return None
    if ia.fits32 and ib.fits32:
        return _i32(a) << sa, _i32(b) << sb
    if ia.fits64 and ib.fits64:
        return _i64(a) << sa, _i64(b) << sb
    raise _unported(op, "limb")


def _host_compare(fn, a: QTensor, b: QTensor, dtype) -> torch.Tensor:
    A, B = np.broadcast_arrays(a.raw().astype(object), b.raw().astype(object))
    out = [fn((int(x), a.fmt), (int(y), b.fmt))
           for x, y in zip(A.reshape(-1), B.reshape(-1))]
    return torch.tensor(out, dtype=dtype).reshape(A.shape).to(a.device)


def qcmp(a, b) -> torch.Tensor:
    """Three-way compare after exact alignment (QuBLAS.h:3332-3345): an
    int8 tensor of -1/0/+1."""
    a, b = _coerce_pair(a, b)
    al = _aligned("qcmp", a, b)
    if al is None:
        return _host_compare(hostops.qcmp, a, b, torch.int8)
    x, y = al
    return (x > y).to(torch.int8) - (x < y).to(torch.int8)


def qeq(a, b) -> torch.Tensor:
    """Equality after exact alignment (QuBLAS.h:3347-3359): a bool
    tensor."""
    a, b = _coerce_pair(a, b)
    al = _aligned("qeq", a, b)
    if al is None:
        return _host_compare(hostops.qeq, a, b, torch.bool)
    x, y = al
    return x == y


def qcast(a: QTensor, fmt: QFormat) -> QTensor:
    """Cross-format conversion (requantize with the destination's modes) —
    reference converting copy ctor (QuBLAS.h:2758-2830).  Equal formats
    return the data unchanged, raws outside the format included."""
    if a.fmt == fmt:
        return QTensor(a.data, fmt)
    route = route_requant(fmt_interval(a.fmt), a.fmt.frac_bits, fmt)
    if route == "host":
        return _host_unary("qcast", lambda v: hostops.convert(v, fmt), a)
    if route == "i32":
        raw = requantize_i32(_i32(a), a.fmt.frac_bits, fmt)
    elif route == "pair":
        raw = requantize_i64(_i64(a), a.fmt.frac_bits, fmt)
    else:
        raise _unported("qcast", route)
    return _finish(raw, fmt)
