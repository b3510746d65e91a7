"""BitStream: bit-level tensor <-> '0'/'1'-string serialization.

The port's copy of ``qublas_tpu/bitstream.py`` (the reference's
``BitStream<orders...>`` converter, ``include/QuBLAS.h:4531-4827``), pinned
to it by ``tests/test_torch_copies.py``.  Host-side: the raws come to the
host as numpy, and parsed raws go back to ``device`` through the port's
``from_raw``, so formats and raws beyond the lanes raise as it does.

Semantics replicated exactly from the reference:

* Each element serializes to its **logical** width
  ``int_bits + frac_bits + int(signed)`` low bits of the raw storage, MSB
  first (``Qu_s::toString``, QuBLAS.h:2433-2438).
* ``l2r`` leaves order as-is; ``r2l(chunk)`` reverses in chunks of ``chunk``
  (elements for the tensor-level order, characters for the element-level
  order) — QuBLAS.h:4546-4562.  Both transforms are involutions, so
  serialization and parsing use the *same* reordering (QuBLAS.h:4654-4666,
  4738-4753).
* Parsing filters out non-'0'/'1' characters first (QuBLAS.h:4768-4771).
* Parsed bits are interpreted **unsigned** and stored raw without masking or
  sign-extension, replicating the reference's ``std::stoi(str, nullptr, 2)``
  + ``fill(int)`` path (QuBLAS.h:4699, 2447-2452): a negative value
  round-trips to ``raw + 2**width``.  Pass ``twos_complement=True`` to
  :func:`from_bits` for a *format-correct* round-trip (an extension — the
  reference cannot do this): the MSB sign-extends only when the target
  format is signed.
* Round-trip guarantee (same as the reference's ``toString``): only the low
  ``width`` bits serialize, so it holds exactly for raws representable in
  ``width`` bits.
* Complex elements serialize real bits then imag bits
  (``str2Qcomplex``, QuBLAS.h:4534-4543).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .qformat import QFormat

__all__ = ["l2r", "r2l", "to_bits", "from_bits", "elem_bits", "parse_elem",
           "to_bits_complex", "from_bits_complex"]


class l2r:  # noqa: N801 — reference-parity name (QuBLAS.h:4546)
    """Identity ordering."""


@dataclass(frozen=True)
class r2l:  # noqa: N801 — reference-parity name (QuBLAS.h:4549-4562)
    """Reverse in chunks of ``chunk`` (default 1 = full reversal)."""

    chunk: int = 1


def _reorder(items, order):
    """Apply an ordering transform to a sequence (the involution shared by
    both serialization directions — QuBLAS.h:4654-4666)."""
    if order is None or order is l2r or isinstance(order, l2r):
        return list(items)
    if isinstance(order, r2l) or (isinstance(order, type) and issubclass(order, r2l)):
        k = order.chunk if isinstance(order, r2l) else 1
        items = list(items)
        if len(items) % k != 0:
            raise ValueError(
                f"Invalid length {len(items)}: must be a multiple of {k}")
        out = []
        for i in range(len(items), 0, -k):
            out.extend(items[i - k:i])
        return out
    raise TypeError(f"bad BitStream order: {order!r}")


def elem_bits(raw: int, width: int) -> str:
    """Low ``width`` bits of ``raw`` (two's complement), MSB first
    (``Qu_s::toString``, QuBLAS.h:2433-2438)."""
    if width <= 0:
        return ""
    return format(raw & ((1 << width) - 1), f"0{width}b")


def parse_elem(bits: str, twos_complement: bool = False) -> int:
    """Binary string -> raw int.  Default: unsigned (reference ``stoi``
    semantics); ``twos_complement=True`` sign-extends the MSB."""
    if not bits:
        return 0
    v = int(bits, 2)
    if twos_complement and bits[0] == "1":
        v -= 1 << len(bits)
    return v


def _flat_raws(qtensor):
    return [int(v) for v in np.asarray(qtensor.raw(), dtype=object).reshape(-1)]


def _from_raws(raws, shape, fmt: QFormat, device):
    """A QTensor of the parsed raws on ``device``; raws beyond the format's
    storage word raise as the port's ``from_raw`` does."""
    from .qtensor import from_raw

    return from_raw(np.array(raws, dtype=object).reshape(shape), fmt, device)


def to_bits(qtensor, tensor_order=None, elem_order=None) -> str:
    """Serialize a QTensor (or scalar QTensor) to a '0'/'1' string.

    Reference entry points ``BitStream<procT>(scalar)`` and
    ``BitStream<tensorOrd, elemOrd>(tensor)`` (QuBLAS.h:4812-4827).
    """
    width = qtensor.fmt.width
    strs = [elem_bits(r, width) for r in _flat_raws(qtensor)]
    strs = ["".join(_reorder(s, elem_order)) for s in strs]
    if qtensor.ndim == 0:
        # scalar path has no tensor-level ordering (QuBLAS.h:4800-4805)
        return strs[0]
    return "".join(_reorder(strs, tensor_order))


def from_bits(bits: str, fmt: QFormat, shape=None, tensor_order=None,
              elem_order=None, twos_complement: bool = False,
              device="cuda"):
    """Parse a bit string into a QTensor of format ``fmt`` on ``device``.

    ``shape=None`` parses a scalar; otherwise the string must contain exactly
    ``prod(shape)`` elements of ``fmt.width`` bits each (after filtering
    non-binary characters, QuBLAS.h:4768-4771).
    """
    filtered = "".join(c for c in bits if c in "01")
    width = fmt.width
    tc = twos_complement and fmt.signed  # unsigned widths carry no sign bit
    if shape is None:
        if len(filtered) != width:
            raise ValueError(
                f"bit string holds {len(filtered)} bits; expected {width}")
        s = "".join(_reorder(filtered, elem_order))
        return _from_raws([parse_elem(s, tc)], (), fmt, device)
    n = int(np.prod(shape)) if shape else 1
    if width == 0:
        raws = [0] * n
    else:
        if len(filtered) != n * width:
            raise ValueError(
                f"bit string holds {len(filtered)} bits; expected {n}x{width}")
        chunks = [filtered[i * width:(i + 1) * width] for i in range(n)]
        if shape != ():
            # 0-d tensors have no tensor-level ordering, mirroring
            # to_bits' scalar path (QuBLAS.h:4800-4805)
            chunks = _reorder(chunks, tensor_order)
        chunks = ["".join(_reorder(c, elem_order)) for c in chunks]
        raws = [parse_elem(c, tc) for c in chunks]
    return _from_raws(raws, shape, fmt, device)


# ---------------------------------------------------------------------------
# Complex variants (real bits ++ imag bits per element — str2Qcomplex,
# QuBLAS.h:4534-4543)
# ---------------------------------------------------------------------------

def to_bits_complex(qcomplex, tensor_order=None, elem_order=None) -> str:
    """Serialize a QComplexTensor: per element, real-part bits then
    imag-part bits, then the same two-level reordering."""
    wr, wi = qcomplex.real.fmt.width, qcomplex.imag.fmt.width
    res = _flat_raws(qcomplex.real)
    ims = _flat_raws(qcomplex.imag)
    strs = [elem_bits(r, wr) + elem_bits(i, wi) for r, i in zip(res, ims)]
    strs = ["".join(_reorder(s, elem_order)) for s in strs]
    if qcomplex.real.ndim == 0:
        return strs[0]
    return "".join(_reorder(strs, tensor_order))


def from_bits_complex(bits: str, real_fmt: QFormat, imag_fmt: QFormat,
                      shape=None, tensor_order=None, elem_order=None,
                      twos_complement: bool = False, device="cuda"):
    """Parse a bit string into a QComplexTensor on ``device`` (real then
    imag bits per element, split at ``real_fmt.width`` —
    QuBLAS.h:4538-4540)."""
    from .complex import QComplexTensor

    filtered = "".join(c for c in bits if c in "01")
    wr, wi = real_fmt.width, imag_fmt.width
    width = wr + wi
    scalar = shape is None
    n = 1 if scalar else (int(np.prod(shape)) if shape else 1)
    if len(filtered) != n * width:
        raise ValueError(
            f"bit string holds {len(filtered)} bits; expected {n}x{width}")
    chunks = [filtered[i * width:(i + 1) * width] for i in range(n)]
    if not scalar:
        chunks = _reorder(chunks, tensor_order)
    chunks = ["".join(_reorder(c, elem_order)) for c in chunks]
    res = [parse_elem(c[:wr], twos_complement and real_fmt.signed)
           for c in chunks]
    ims = [parse_elem(c[wr:], twos_complement and imag_fmt.signed)
           for c in chunks]
    out_shape = () if scalar else shape
    return QComplexTensor(_from_raws(res, out_shape, real_fmt, device),
                          _from_raws(ims, out_shape, imag_fmt, device))
