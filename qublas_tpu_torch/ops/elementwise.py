"""Elementwise quantized ops on torch (Qmul/Qadd/Qsub/Qdiv/Qabs/Qneg/Qcmp/
Qeq and the converting cast).

Port of ``qublas_tpu/ops/elementwise.py``.  Each op is a short torch
program — exact widened arithmetic, then the round -> overflow epilogue of
:mod:`.wideint` or :mod:`.limbint` — chosen per op configuration by the
width proofs of :mod:`.widths`, before any data is touched:

* ``i32`` (and ``split`` for a product wider than int32): int32 lanes;
* ``pair``: int64 tensors, the JAX package's emulated (hi, lo) pairs, into
  a lane or a pair-storage result;
* ``limb``: stacked 32-bit limbs (:mod:`.limbint`, working widths up to
  1,024 bits), from and into any device storage;
* ``host``: the exact golden model (:mod:`..hostops`), one Python int per
  element, into lane, pair or limb storage; a result that needs host
  storage (beyond 992 bits) raises (ROADMAP A4b).

All of them run on the tensors' own device.  They are plain torch ops on
the card too: the JAX package runs them as XLA ops, not as Pallas kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import hostops
from ..qformat import QFormat, add_merge, mul_merge
from ..qtensor import QTensor, from_float, from_raw, host_storage_error
from . import limbint as L
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
    limb_count,
    requant_work_bits,
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


def _coerce_pair(a, b):
    if not isinstance(a, QTensor) and isinstance(b, QTensor):
        a = from_float(a, b.fmt, b.device)
    if not isinstance(b, QTensor) and isinstance(a, QTensor):
        b = from_float(b, a.fmt, a.device)
    if not (isinstance(a, QTensor) and isinstance(b, QTensor)):
        raise TypeError("elementwise ops need at least one QTensor operand")
    return a, b


def _host_binary(fn, a: QTensor, b: QTensor, **kw) -> QTensor:
    """``fn`` of the golden model per element, into device storage."""
    _, out_fmt = fn((0, a.fmt), (0, b.fmt), **kw)
    if storage_kind(out_fmt) is None:
        raise host_storage_error(f"{fn.__name__} into {out_fmt}")
    A, B = np.broadcast_arrays(a.raw().astype(object), b.raw().astype(object))
    raws = [fn((int(x), a.fmt), (int(y), b.fmt), **kw)[0]
            for x, y in zip(A.reshape(-1), B.reshape(-1))]
    return from_raw(np.array(raws, dtype=object).reshape(A.shape), out_fmt,
                    a.device)


def _host_unary(name: str, fn, a: QTensor) -> QTensor:
    _, out_fmt = fn((0, a.fmt))
    if storage_kind(out_fmt) is None:
        raise host_storage_error(f"{name} into {out_fmt}")
    raws = [fn((int(x), a.fmt))[0] for x in a.raw().reshape(-1)]
    return from_raw(np.array(raws, dtype=object).reshape(a.shape), out_fmt,
                    a.device)


def _finish(raw: torch.Tensor, out_fmt: QFormat) -> QTensor:
    """Store a result in the format's storage: an int32 or int64 result
    narrowed to its lane (wrapping, as the JAX package's ``astype`` and
    ``pair_to_int32`` do), int64 for pair storage, the stacked limbs of
    :func:`~.limbint.store_limbs` for limb storage."""
    if storage_kind(out_fmt) == "limb":
        return QTensor(L.LimbArray(raw), out_fmt)
    return QTensor(raw.to(storage_dtype(out_fmt)), out_fmt)


def _i32(t: QTensor) -> torch.Tensor:
    """Load as int32 lanes (the route proved that the values fit)."""
    return t.data.to(torch.int32)


def _i64(t: QTensor) -> torch.Tensor:
    """Load lane or pair storage as int64 (the JAX package's
    ``_load_pair``)."""
    return t.data.to(torch.int64)


def _load_limb(t: QTensor, K: int) -> torch.Tensor:
    """Load any device storage as K stacked limbs."""
    if t.is_limb:
        return L.lext(t.data.limbs, K)
    return L.limbs_from_i64(t.data, K)


def _load_limbs(a: QTensor, b: QTensor, K: int):
    """Both operands as K stacked limbs over their broadcast shape."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return (L.lbroadcast_elem(_load_limb(a, K), shape),
            L.lbroadcast_elem(_load_limb(b, K), shape))


def _limb_work(*bit_counts) -> int:
    """Working limb count covering every listed bit width."""
    return L.bits_to_limbs(max(bit_counts))


def qmul(a, b, to=None, full_prec: bool = False) -> QTensor:
    """Quantized multiply: exact product -> round -> saturate
    (QuBLAS.h:3146-3171)."""
    a, b = _coerce_pair(a, b)
    out = mul_merge(a.fmt, b.fmt, to, full_prec)
    route, prod, from_frac = route_mul(a.fmt, b.fmt, out)
    if route == "host":
        return _host_binary(hostops.qmul, a, b, to=to, full_prec=full_prec)
    if route == "i32":
        raw = requantize_i32(_i32(a) * _i32(b), from_frac, out)
    elif route == "split":
        raw = requantize_split_mul(_i32(a), _i32(b), from_frac, out)
    elif route == "pair":
        raw = requantize_i64(mul_wide(a.data, b.data), from_frac, out)
    else:
        K = _limb_work(prod.bits, requant_work_bits(prod, from_frac, out))
        raw = L.requantize_limb(L.lmul(*_load_limbs(a, b, K), K), from_frac,
                                out)
    return _finish(raw, out)


def _addsub(a, b, to, full_prec, sub: bool) -> QTensor:
    a, b = _coerce_pair(a, b)
    out = add_merge(a.fmt, b.fmt, to, full_prec)
    route, siv, f, ia, ib = route_addsub(a.fmt, b.fmt, out, sub)
    if route == "host":
        return _host_binary(hostops.qsub if sub else hostops.qadd, a, b,
                            to=to, full_prec=full_prec)
    if route == "limb":
        # working width from the same intervals the route proof used
        K = _limb_work(ia.bits, ib.bits, siv.bits,
                       requant_work_bits(siv, f, out))
        xs, ys = _load_limbs(a, b, K)
        xs = L.lshl(xs, f - a.fmt.frac_bits)
        ys = L.lshl(ys, f - b.fmt.frac_bits)
        s = L.lsub(xs, ys) if sub else L.ladd(xs, ys)
        return _finish(L.requantize_limb(s, f, out), out)
    if route == "i32":
        load, requant = _i32, requantize_i32
    else:
        load, requant = _i64, requantize_i64
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
    route, num, den = route_div(a.fmt, b.fmt, out)
    if route == "host":
        return _host_binary(hostops.qdiv, a, b, to=to, full_prec=full_prec)
    sb = max(a.fmt.frac_bits - b.fmt.frac_bits, 0)
    s = max(b.fmt.frac_bits - a.fmt.frac_bits, 0) + out.frac_bits
    if route == "limb":
        # bit-serial restoring division; the working width from the same
        # intervals the route proof used (the quotient's magnitude is the
        # numerator's at most)
        mag = max(abs(num.lo), abs(num.hi))
        quot = Interval(-mag, mag)
        K = _limb_work(num.bits, den.bits, quot.bits,
                       requant_work_bits(quot, out.frac_bits, out))
        xs, ys = _load_limbs(a, b, K)
        xs, ys = L.lshl(xs, s), L.lshl(ys, sb)
        q = L.ldiv_trunc(xs, ys, min(32 * K, num.bits))
        # divide by zero -> 0 (the divider returns all ones there)
        zero = torch.zeros_like(q)
        q = L.lselect(L.leq(ys, zero), zero, q)
        # no frac stage (d == 0 at out.frac_bits): overflow stage only
        return _finish(L.requantize_limb(q, out.frac_bits, out), out)
    if route == "pair":
        # no frac stage (d == 0 at out.frac_bits): overflow stage only
        q = div_trunc_i64(_i64(a) << s, _i64(b) << sb)
        return _finish(requantize_i64(q, out.frac_bits, out), out)
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


def _neg_route(fmt: QFormat, out: QFormat):
    """The route of ``fmt``'s negation into ``out`` and its working bits:
    "i32" (a lane result whose word holds every raw and its negation,
    -INT32_MIN guarded), "pair" (int64, within the pair margin, for a pair
    result), "limb" (stacked limbs for a limb result whose limb word holds
    the exact negation) or "host": the golden model never wraps the
    negation, so a store that would truncate it goes there."""
    iv = fmt_interval(fmt)
    neg = Interval(-iv.hi, -iv.lo)
    bits = max(iv.bits, neg.bits)
    kind = storage_kind(out)
    if iv.fits32 and neg.fits32 and kind == "lane":
        return "i32", bits
    if iv.fits64 and neg.fits64 and kind == "pair" and bits <= 64:
        return "pair", bits
    if kind == "limb" and bits <= min(32 * limb_count(out),
                                      LIMB_INTER_MAX_BITS):
        return "limb", bits
    return "host", bits


def qabs(a: QTensor) -> QTensor:
    """Absolute value (QuBLAS.h:3273-3300): unsigned is identity; signed
    widens int_bits by one, no requantization."""
    if not a.fmt.signed:
        return a
    out = _neg_out(a.fmt)
    route, bits = _neg_route(a.fmt, out)
    if route == "host":
        return _host_unary("qabs", hostops.qabs, a)
    if route == "limb":
        x = _load_limb(a, L.bits_to_limbs(bits))
        return _finish(L.store_limbs(L.lselect(L.lis_neg(x), L.lneg(x), x),
                                     out), out)
    x = _i32(a) if route == "i32" else _i64(a)
    return _finish(torch.where(x < 0, -x, x), out)


def qneg(a: QTensor) -> QTensor:
    """Negation (QuBLAS.h:3307-3317): widens int_bits by one."""
    out = _neg_out(a.fmt)
    route, bits = _neg_route(a.fmt, out)
    if route == "host":
        return _host_unary("qneg", hostops.qneg, a)
    if route == "limb":
        x = _load_limb(a, L.bits_to_limbs(bits))
        return _finish(L.store_limbs(L.lneg(x), out), out)
    return _finish(-(_i32(a) if route == "i32" else _i64(a)), out)


def _aligned(a: QTensor, b: QTensor):
    """Both operands at the common fractional scale, with the domain that
    holds them: int32 lanes ("i32"), int64 ("pair") or stacked limbs
    ("limb"); None when only the host can align them."""
    f = max(a.fmt.frac_bits, b.fmt.frac_bits)
    sa, sb = f - a.fmt.frac_bits, f - b.fmt.frac_bits
    ia = fmt_interval(a.fmt) << sa
    ib = fmt_interval(b.fmt) << sb
    if max(ia.bits, ib.bits) > LIMB_INTER_MAX_BITS:
        return None
    if ia.fits32 and ib.fits32:
        return _i32(a) << sa, _i32(b) << sb, "i32"
    if ia.fits64 and ib.fits64:
        return _i64(a) << sa, _i64(b) << sb, "pair"
    xs, ys = _load_limbs(a, b, _limb_work(ia.bits, ib.bits))
    return L.lshl(xs, sa), L.lshl(ys, sb), "limb"


def _host_compare(fn, a: QTensor, b: QTensor, dtype) -> torch.Tensor:
    A, B = np.broadcast_arrays(a.raw().astype(object), b.raw().astype(object))
    out = [fn((int(x), a.fmt), (int(y), b.fmt))
           for x, y in zip(A.reshape(-1), B.reshape(-1))]
    return torch.tensor(out, dtype=dtype).reshape(A.shape).to(a.device)


def qcmp(a, b) -> torch.Tensor:
    """Three-way compare after exact alignment (QuBLAS.h:3332-3345): an
    int8 tensor of -1/0/+1."""
    a, b = _coerce_pair(a, b)
    al = _aligned(a, b)
    if al is None:
        return _host_compare(hostops.qcmp, a, b, torch.int8)
    x, y, kind = al
    if kind == "limb":
        return L.llt(y, x).to(torch.int8) - L.llt(x, y).to(torch.int8)
    return (x > y).to(torch.int8) - (x < y).to(torch.int8)


def qeq(a, b) -> torch.Tensor:
    """Equality after exact alignment (QuBLAS.h:3347-3359): a bool
    tensor."""
    a, b = _coerce_pair(a, b)
    al = _aligned(a, b)
    if al is None:
        return _host_compare(hostops.qeq, a, b, torch.bool)
    x, y, kind = al
    return L.leq(x, y) if kind == "limb" else x == y


def qcast(a: QTensor, fmt: QFormat) -> QTensor:
    """Cross-format conversion (requantize with the destination's modes) —
    reference converting copy ctor (QuBLAS.h:2758-2830).  Equal formats
    return the data unchanged, raws outside the format included."""
    if a.fmt == fmt:
        return QTensor(a.data, fmt)
    iv = fmt_interval(a.fmt)
    route = route_requant(iv, a.fmt.frac_bits, fmt)
    if route == "host":
        return _host_unary("qcast", lambda v: hostops.convert(v, fmt), a)
    if route == "i32":
        raw = requantize_i32(_i32(a), a.fmt.frac_bits, fmt)
    elif route == "pair":
        raw = requantize_i64(_i64(a), a.fmt.frac_bits, fmt)
    else:
        K = _limb_work(iv.bits, requant_work_bits(iv, a.fmt.frac_bits, fmt))
        raw = L.requantize_limb(_load_limb(a, K), a.fmt.frac_bits, fmt)
    return _finish(raw, fmt)
