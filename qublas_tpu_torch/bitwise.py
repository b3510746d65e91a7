"""Raw-bitwise tensor ops and decimal-string I/O (the reference's ArbiInt
layer) on torch tensors.

Port of ``qublas_tpu.bitwise``.  The reference exposes ``^ & | ~`` on
``ArbiInt<N>`` (QuBLAS.h:1836-1978: two's-complement bitwise with the
narrower operand sign-extended, result width ``max(N, M)``, ``~`` at its
operand's width) and a decimal string constructor and printer
(QuBLAS.h:216-336, :506-518, :538-563):

* ``qand/qor/qxor(a, b)`` — elementwise two's-complement bitwise on the raw
  storage integers; the result carries the format of the operand with the
  wider storage, the narrower operand sign-extends.  No requantize stage:
  bitwise results stay in the wider storage range.
* ``qnot(a)`` — ``~raw`` at the operand's own format.
* ``from_decimal(strings, fmt, device)`` — decimal strings -> raws, wrapped
  at the 64-bit-multiple machine word like the reference's limb-array
  parse, then read as two's complement; on the host, as in the JAX
  package, and placed on ``device``.
* ``to_decimal(t)`` — decimal strings of the raws.

Device routes, on the tensors' own device: lanes (one torch op in the
widest of both lane dtypes and the format's own, so that ``fill(int)``
wart raws keep their bits), pairs (the int64 raw; a lane operand widens),
limbs (both operands lifted to the result's limb count with
:func:`~.ops.limbint.lext`, then the op limb by limb; limbs are values in
``[0, 2^32)`` held in int64, so ``~`` masks each limb back to 32 bits).
Host operands and host-storage result formats (beyond 992 bits) take the
host route: Python ints, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import limbint as L
from .ops.widths import limb_count, storage_kind, torch_dtype_for
from .qformat import QFormat
from .qtensor import QTensor, from_raw, result_device

__all__ = ["qand", "qor", "qxor", "qnot", "from_decimal", "to_decimal"]


def _wrap_word(v: int, fmt: QFormat) -> int:
    """Wrap a Python int at the format's 64-bit-multiple machine word,
    signed (the reference's limb-array store)."""
    word = 64 * ((max(fmt.storage_bits, 1) + 63) // 64)
    v &= (1 << word) - 1
    return v - (1 << word) if v >= (1 << (word - 1)) else v


def _lift(t: QTensor, K: int) -> torch.Tensor:
    """``t``'s raws as K sign-extended limbs."""
    if t.is_limb:
        return L.lext(t.data.limbs, K)
    return L.limbs_from_i64(t.data, K)


def _bitwise(op, a: QTensor, b: QTensor) -> QTensor:
    fmt = a.fmt if a.fmt.storage_bits >= b.fmt.storage_bits else b.fmt
    kind = storage_kind(fmt)
    if a.is_host or b.is_host or kind is None:
        pyop = {torch.bitwise_and: int.__and__, torch.bitwise_or: int.__or__,
                torch.bitwise_xor: int.__xor__}[op]
        A, B = np.broadcast_arrays(np.asarray(a.raw(), dtype=object),
                                   np.asarray(b.raw(), dtype=object))
        flat = [pyop(int(x), int(y)) for x, y in zip(A.reshape(-1),
                                                      B.reshape(-1))]
        return from_raw(np.array(flat, dtype=object).reshape(A.shape), fmt,
                        result_device(a, b))
    if kind == "lane":
        dt = torch.promote_types(torch.promote_types(a.data.dtype,
                                                     b.data.dtype),
                                 torch_dtype_for(fmt))
        return QTensor(op(a.data.to(dt), b.data.to(dt)), fmt)
    if kind == "pair":
        return QTensor(op(a.data.to(torch.int64), b.data.to(torch.int64)),
                       fmt)
    K = limb_count(fmt)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return QTensor(L.LimbArray(op(L.lbroadcast_elem(_lift(a, K), shape),
                                  L.lbroadcast_elem(_lift(b, K), shape))),
                   fmt)


def qand(a: QTensor, b: QTensor) -> QTensor:
    """Elementwise raw ``&`` (reference ArbiInt operator&,
    QuBLAS.h:1878-1906)."""
    return _bitwise(torch.bitwise_and, a, b)


def qor(a: QTensor, b: QTensor) -> QTensor:
    """Elementwise raw ``|`` (QuBLAS.h:1908-1936)."""
    return _bitwise(torch.bitwise_or, a, b)


def qxor(a: QTensor, b: QTensor) -> QTensor:
    """Elementwise raw ``^`` (QuBLAS.h:1836-1876)."""
    return _bitwise(torch.bitwise_xor, a, b)


def qnot(a: QTensor) -> QTensor:
    """Elementwise raw ``~`` at the operand's own format
    (QuBLAS.h:1964-1978: ``~ArbiInt<N> -> ArbiInt<N>``)."""
    if a.is_host:
        flat = [~int(x) for x in a.raw().reshape(-1)]
        return from_raw(np.array(flat, dtype=object).reshape(a.shape), a.fmt,
                        a.device)
    if a.is_limb:
        return QTensor(L.LimbArray(~a.data.limbs & L.M32), a.fmt)
    return QTensor(~a.data, a.fmt)


def from_decimal(strings, fmt: QFormat, device="cuda") -> QTensor:
    """Decimal raw-value string(s) -> QTensor on ``device`` (reference
    ArbiInt string ctor, QuBLAS.h:506-518 via string_to_big_integer
    :216-269: the decimal parses into the limb array mod 2^(64*words))."""
    arr = np.asarray(strings)
    flat = [_wrap_word(int(s), fmt) for s in arr.reshape(-1)]
    return from_raw(np.array(flat, dtype=object).reshape(arr.shape), fmt,
                    device)


def to_decimal(t: QTensor):
    """Decimal strings of the raw values (reference ``toString``,
    QuBLAS.h:538-563): a NumPy array of str with the tensor's shape."""
    A = np.asarray(t.raw(), dtype=object)
    out = np.array([str(int(v)) for v in A.reshape(-1)], dtype=object)
    return out.reshape(A.shape)
