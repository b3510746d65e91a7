"""Fixed-point format descriptors and output-format inference.

The port's own copy of ``qublas_tpu/qformat.py``, pinned to it by
``tests/test_torch_copies.py``.  The reference encodes formats as C++
template tags ``Qu<intBits<I>, fracBits<F>, isSigned<S>, QuMode<R>,
OfMode<O>>`` parsed by ``tagExtractor`` (reference
``include/QuBLAS.h:133-190``, ``:2346-2498``).  Here a format is a *value*: a
frozen dataclass carried beside a raw-integer torch tensor inside a
:class:`~qublas_tpu_torch.qtensor.QTensor`.  A format from another package
with the same fields converts with
:func:`qublas_tpu_torch.convert.port_format`.

Defaults match the reference exactly (``QuBLAS.h:2355-2359``):
int_bits=8, frac_bits=8, signed=True, RoundMode.TRN_TCPL, OverflowMode.SAT_TCPL.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace


class RoundMode(enum.IntEnum):
    """Rounding (quantization) modes — reference ``QuBLAS.h:1986-1999``.

    Values match the reference's ``::value`` constants so traces/goldens can
    name modes by number.
    """

    RND_POS_INF = 0  # round half up
    RND_NEG_INF = 1  # round half down
    RND_ZERO = 2     # round half toward zero
    RND_INF = 3      # round half away from zero
    RND_CONV = 4     # round half to even (convergent)
    TRN_TCPL = 5     # truncate toward -inf (two's complement arithmetic shift)
    TRN_SMGN = 6     # truncate toward zero (sign-magnitude)


class OverflowMode(enum.IntEnum):
    """Overflow handling modes — reference ``QuBLAS.h:2209-2225``."""

    SAT_TCPL = 0      # clamp to [min, max]
    SAT_ZERO = 1      # any overflow -> 0
    SAT_SMGN = 2      # clamp to [min+1, max] (symmetric)
    WRP_TCPL = 3      # wrap (mask + sign-extend)
    # Stub in the reference: intConvert is the identity (QuBLAS.h:2336-2344)
    # and the subsequent ArbiInt store wraps to the storage *machine word*
    # (int32 for storage <= 32 bits, int64 <= 64) — probed and pinned by
    # goldens; see hostint.int_convert.
    WRP_TCPL_SAT = 4


DEFAULT_INT_BITS = 8
DEFAULT_FRAC_BITS = 8
DEFAULT_SIGNED = True
DEFAULT_ROUND = RoundMode.TRN_TCPL
DEFAULT_OVERFLOW = OverflowMode.SAT_TCPL


@dataclass(frozen=True)
class QFormat:
    """A fixed-point number format.

    Mirrors the semantic content of the reference's ``Qu_s`` scalar type
    (``QuBLAS.h:2368-2478``):

    * ``int_bits``/``frac_bits`` may be negative (``readme.md:34-36``); the
      only constraint is ``int_bits + frac_bits >= 0`` (``QuBLAS.h:2372``).
    * The *storage* always carries a physical sign bit regardless of
      ``signed`` (``QuBLAS.h:2384-2385``): raw values live in
      ``1 + int_bits + frac_bits`` bits two's complement.
    * The *logical* width (used by BitStream serialization, ``QuBLAS.h:2377``)
      is ``int_bits + frac_bits + int(signed)``.
    """

    int_bits: int = DEFAULT_INT_BITS
    frac_bits: int = DEFAULT_FRAC_BITS
    signed: bool = DEFAULT_SIGNED
    round_mode: RoundMode = DEFAULT_ROUND
    overflow_mode: OverflowMode = DEFAULT_OVERFLOW

    def __post_init__(self):
        if self.int_bits + self.frac_bits < 0:
            raise ValueError(
                "The total number of bits must be non-negative: "
                f"int_bits={self.int_bits}, frac_bits={self.frac_bits}"
            )

    # --- widths -----------------------------------------------------------
    @property
    def storage_bits(self) -> int:
        """Physical two's-complement storage width (always has a sign bit)."""
        return 1 + self.int_bits + self.frac_bits

    @property
    def width(self) -> int:
        """Logical bit width (what BitStream serializes)."""
        return self.int_bits + self.frac_bits + int(self.signed)

    # --- raw-value range (storage) ----------------------------------------
    @property
    def raw_max(self) -> int:
        """Maximum representable raw integer: 2^(storage_bits-1) - 1."""
        return (1 << (self.storage_bits - 1)) - 1

    @property
    def raw_min(self) -> int:
        """Minimum raw integer of the *storage*.

        Saturation clamps the low side to 0 for unsigned formats
        (``QuBLAS.h:2237``), but the storage itself is signed.
        """
        return -(1 << (self.storage_bits - 1))

    @property
    def scale(self) -> float:
        return 2.0 ** (-self.frac_bits)

    # --- conveniences -------------------------------------------------------
    def with_modes(self, round_mode=None, overflow_mode=None) -> "QFormat":
        kw = {}
        if round_mode is not None:
            kw["round_mode"] = RoundMode(round_mode)
        if overflow_mode is not None:
            kw["overflow_mode"] = OverflowMode(overflow_mode)
        return replace(self, **kw)

    def __repr__(self):
        return (
            f"QFormat({self.int_bits},{self.frac_bits},"
            f"{'s' if self.signed else 'u'},"
            f"{self.round_mode.name},{self.overflow_mode.name})"
        )


def qformat(
    int_bits: int = DEFAULT_INT_BITS,
    frac_bits: int = DEFAULT_FRAC_BITS,
    signed: bool = DEFAULT_SIGNED,
    round_mode: RoundMode = DEFAULT_ROUND,
    overflow_mode: OverflowMode = DEFAULT_OVERFLOW,
) -> QFormat:
    """Keyword-argument replacement for the reference's tag soup.

    All arguments are optional and order-free, matching ``readme.md:30``.
    """
    return QFormat(int_bits, frac_bits, bool(signed), RoundMode(round_mode),
                   OverflowMode(overflow_mode))


# Sentinel requesting full-precision output-format inference
# (reference ``FullPrec`` tag, QuBLAS.h:3079).
class FullPrec:
    def __repr__(self):
        return "FullPrec"


FULL_PREC = FullPrec()


def _merge_modes(a: QFormat, b: QFormat):
    """Shared mode if operand modes agree, else library default.

    Reference: MulMerger/AddMerger ``fromQuMode``/``fromOfMode``
    (QuBLAS.h:3111-3112, 3130-3131).
    """
    rm = a.round_mode if a.round_mode == b.round_mode else DEFAULT_ROUND
    om = a.overflow_mode if a.overflow_mode == b.overflow_mode else DEFAULT_OVERFLOW
    return rm, om


def _resolve(to, base: QFormat) -> QFormat:
    """Apply a user-supplied output spec over an inferred base format.

    ``to`` may be None (use base), a QFormat (use it verbatim — like passing
    a full Qu type as the template argument), or a dict of overrides (like
    passing individual tags).
    """
    if to is None:
        return base
    if isinstance(to, QFormat):
        return to
    if isinstance(to, dict):
        kw = dict(
            int_bits=base.int_bits,
            frac_bits=base.frac_bits,
            signed=base.signed,
            round_mode=base.round_mode,
            overflow_mode=base.overflow_mode,
        )
        kw.update(to)
        return qformat(**kw)
    raise TypeError(f"bad output format spec: {to!r}")


def mul_merge(a: QFormat, b: QFormat, to=None, full_prec: bool = False) -> QFormat:
    """Output format of a multiply — reference MulMerger (QuBLAS.h:3104-3121).

    Default: int_bits = max, frac_bits = max.  FullPrec: sums.
    Signedness ORs.  Modes: shared if equal else default.  Any field can be
    overridden by ``to``.
    """
    rm, om = _merge_modes(a, b)
    if full_prec:
        base = QFormat(a.int_bits + b.int_bits, a.frac_bits + b.frac_bits,
                       a.signed or b.signed, rm, om)
    else:
        base = QFormat(max(a.int_bits, b.int_bits), max(a.frac_bits, b.frac_bits),
                       a.signed or b.signed, rm, om)
    return _resolve(to, base)


def add_merge(a: QFormat, b: QFormat, to=None, full_prec: bool = False) -> QFormat:
    """Output format of an add/sub/div — reference AddMerger (QuBLAS.h:3123-3140).

    Default: int_bits = max (FullPrec: max+1), frac_bits = max.
    """
    rm, om = _merge_modes(a, b)
    int_bits = max(a.int_bits, b.int_bits) + (1 if full_prec else 0)
    base = QFormat(int_bits, max(a.frac_bits, b.frac_bits),
                   a.signed or b.signed, rm, om)
    return _resolve(to, base)
