"""Elementwise quantized ops on torch (Qmul/Qadd/Qsub/Qdiv/Qabs/Qneg/Qcmp/
Qeq and the converting cast).

Port of ``qublas_tpu/ops/elementwise.py`` for lane storage.  Each op is a
short torch program on int32 lanes — exact widened arithmetic, then the
round -> overflow epilogue of :mod:`.wideint` — chosen per op configuration
by the width proofs of :mod:`.widths`, before any data is touched:

* ``i32`` (and ``split`` for a product wider than int32): torch ops on the
  tensors' own device;
* ``host`` with a lane-storage result: the exact golden model
  (:mod:`..hostops`), one Python int per element;
* ``pair`` and ``limb``: not yet ported (ROADMAP items 10-11), they raise.

These are plain torch ops on the card too: the JAX package runs them as
XLA ops, not as Pallas kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import hostops
from ..qformat import QFormat, add_merge, mul_merge
from ..qtensor import QTensor, from_float, from_raw
from .wideint import _overflow_i32, requantize_i32, requantize_split_mul
from .widths import (
    LIMB_INTER_MAX_BITS,
    Interval,
    fmt_interval,
    route_addsub,
    route_div,
    route_mul,
    route_requant,
    storage_kind,
    torch_dtype_for,
)

__all__ = ["qmul", "qadd", "qsub", "qdiv", "qabs", "qneg", "qcmp", "qeq",
           "qcast"]

I32_MIN = -(1 << 31)


def _unported(op: str, route: str):
    return NotImplementedError(
        f"{op}: the {route!r} route is not yet ported (ROADMAP items 10-11)")


def _coerce_pair(a, b):
    if not isinstance(a, QTensor) and isinstance(b, QTensor):
        a = from_float(a, b.fmt, b.device)
    if not isinstance(b, QTensor) and isinstance(a, QTensor):
        b = from_float(b, a.fmt, a.device)
    if not (isinstance(a, QTensor) and isinstance(b, QTensor)):
        raise TypeError("elementwise ops need at least one QTensor operand")
    return a, b


def _host_binary(fn, a: QTensor, b: QTensor, **kw) -> QTensor:
    """``fn`` of the golden model per element, for a lane-storage result."""
    _, out_fmt = fn((0, a.fmt), (0, b.fmt), **kw)
    if storage_kind(out_fmt) != "lane":
        raise _unported(fn.__name__, "host")
    A, B = np.broadcast_arrays(a.raw().astype(object), b.raw().astype(object))
    raws = [fn((int(x), a.fmt), (int(y), b.fmt), **kw)[0]
            for x, y in zip(A.reshape(-1), B.reshape(-1))]
    return from_raw(np.array(raws, dtype=np.int64).reshape(A.shape), out_fmt,
                    a.device)


def _host_unary(name: str, fn, a: QTensor) -> QTensor:
    _, out_fmt = fn((0, a.fmt))
    if storage_kind(out_fmt) != "lane":
        raise _unported(name, "host")
    raws = [fn((int(x), a.fmt))[0] for x in a.raw().reshape(-1)]
    return from_raw(np.array(raws, dtype=np.int64).reshape(a.shape), out_fmt,
                    a.device)


def _finish(raw: torch.Tensor, out_fmt: QFormat) -> QTensor:
    """Narrow an int32 result to the format's lane (wrapping, as the JAX
    package's ``astype`` does)."""
    return QTensor(raw.to(torch_dtype_for(out_fmt)), out_fmt)


def _i32(t: QTensor) -> torch.Tensor:
    return t.data.to(torch.int32)


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
    if route != "i32":
        raise _unported("qsub" if sub else "qadd", route)
    x = _i32(a) << (f - a.fmt.frac_bits)
    y = _i32(b) << (f - b.fmt.frac_bits)
    return _finish(requantize_i32(x - y if sub else x + y, f, out), out)


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
    if route != "i32":
        raise _unported("qdiv", route)
    sb = max(a.fmt.frac_bits - b.fmt.frac_bits, 0)
    s = max(b.fmt.frac_bits - a.fmt.frac_bits, 0) + out.frac_bits
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


def _neg_on_lanes(fmt: QFormat, out: QFormat) -> bool:
    """The negation of every raw of ``fmt`` fits an int32 lane (it guards
    -INT32_MIN), and the result is lane storage."""
    iv = fmt_interval(fmt)
    return iv.fits32 and Interval(-iv.hi, -iv.lo).fits32 \
        and storage_kind(out) == "lane"


def qabs(a: QTensor) -> QTensor:
    """Absolute value (QuBLAS.h:3273-3300): unsigned is identity; signed
    widens int_bits by one, no requantization."""
    if not a.fmt.signed:
        return a
    out = _neg_out(a.fmt)
    if not _neg_on_lanes(a.fmt, out):
        return _host_unary("qabs", hostops.qabs, a)
    x = _i32(a)
    return _finish(torch.where(x < 0, -x, x), out)


def qneg(a: QTensor) -> QTensor:
    """Negation (QuBLAS.h:3307-3317): widens int_bits by one."""
    out = _neg_out(a.fmt)
    if not _neg_on_lanes(a.fmt, out):
        return _host_unary("qneg", hostops.qneg, a)
    return _finish(-_i32(a), out)


def _aligned(op: str, a: QTensor, b: QTensor):
    """Both operands at the common fractional scale on int32 lanes, or
    None when only the host can align them."""
    f = max(a.fmt.frac_bits, b.fmt.frac_bits)
    sa, sb = f - a.fmt.frac_bits, f - b.fmt.frac_bits
    ia = fmt_interval(a.fmt) << sa
    ib = fmt_interval(b.fmt) << sb
    if max(ia.bits, ib.bits) > LIMB_INTER_MAX_BITS:
        return None
    if not (ia.fits32 and ib.fits32):
        raise _unported(op, "pair" if ia.fits64 and ib.fits64 else "limb")
    return _i32(a) << sa, _i32(b) << sb


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
    if route != "i32":
        raise _unported("qcast", route)
    return _finish(requantize_i32(_i32(a), a.fmt.frac_bits, fmt), fmt)
