"""Exact host-side fixed-point arithmetic on Python integers.

This is the bit-exact *golden model*: every device path (torch int32 lanes,
the CUDA kernels) is checked against these functions.  The port's own copy
of ``qublas_tpu/hostint.py``, pinned to it by ``tests/test_torch_copies.py``;
the original is checked against golden vectors of the reference C++
simulator (``tests/golden_data/``).

The reference guarantees exactness by widening every intermediate to an
``ArbiInt`` that can hold it (reference ``include/QuBLAS.h:338-1979``).
Python integers are arbitrary precision by construction, so the entire width
algebra collapses to plain ``int`` arithmetic here; what remains is the
semantic contract of the two conversion stages:

* ``frac_convert`` — re-scale between fractional precisions with one of the
  seven rounding modes (reference ``fracConvert``, QuBLAS.h:2002-2204).
* ``int_convert``  — clamp/wrap into the target storage width with one of the
  five overflow modes (reference ``intConvert``, QuBLAS.h:2227-2344).

Order matters and is fixed: **widen exactly → round → saturate**
(see e.g. Qmul_s::mul, QuBLAS.h:3152-3170).

Arbitrary widths are supported (the reference tests go to 200-bit formats);
this path is used directly for any format whose intermediates do not fit
int32 lanes, and as the oracle for the ones that do.
"""

from __future__ import annotations

import math

from .qformat import QFormat, OverflowMode, RoundMode

__all__ = [
    "frac_convert",
    "int_convert",
    "requantize",
    "double_to_raw",
    "raw_to_double",
    "trunc_div",
]


def frac_convert(val: int, from_frac: int, to_frac: int, mode: RoundMode) -> int:
    """Re-scale raw integer ``val`` from ``from_frac`` to ``to_frac``
    fractional bits, rounding per ``mode``.

    Semantics match reference ``fracConvert`` bit-for-bit
    (QuBLAS.h:2002-2204).  If precision increases the shift is exact for all
    modes (QuBLAS.h:2011-2014).
    """
    d = from_frac - to_frac
    if d <= 0:
        return val << (-d)

    # Xh: arithmetic shift right (floor); Xl: dropped low bits; T: half ulp.
    xh = val >> d
    xl = val & ((1 << d) - 1)
    t = 1 << (d - 1)

    if mode == RoundMode.TRN_TCPL:
        return xh
    if mode == RoundMode.TRN_SMGN:
        # truncate toward zero (QuBLAS.h:2170-2204)
        return -((-val) >> d) if val < 0 else xh
    if mode == RoundMode.RND_POS_INF:
        carry = xl >= t
    elif mode == RoundMode.RND_NEG_INF:
        carry = xl > t
    elif mode == RoundMode.RND_ZERO:
        carry = xl > t or (xl == t and val < 0)
    elif mode == RoundMode.RND_INF:
        carry = xl > t or (xl == t and val > 0)
    elif mode == RoundMode.RND_CONV:
        # round half to even on the kept part (QuBLAS.h:2125-2159)
        carry = xl > t or (xl == t and (xh & 1) == 1)
    else:  # pragma: no cover
        raise ValueError(f"unknown rounding mode {mode}")
    return xh + (1 if carry else 0)


def int_convert(val: int, fmt: QFormat) -> int:
    """Clamp/wrap ``val`` into ``fmt``'s storage width per its overflow mode.

    Semantics match reference ``intConvert`` (QuBLAS.h:2227-2344).  Bounds are
    those of the physical ``1 + int_bits + frac_bits``-bit storage — the sign
    bit is always present; unsigned formats only change the lower bound.
    """
    w = fmt.storage_bits
    hi = (1 << (w - 1)) - 1
    mode = fmt.overflow_mode

    if mode == OverflowMode.SAT_TCPL:
        lo = -(1 << (w - 1)) if fmt.signed else 0
        return hi if val > hi else lo if val < lo else val
    if mode == OverflowMode.SAT_ZERO:
        lo = -(1 << (w - 1)) if fmt.signed else 0
        return 0 if (val > hi or val < lo) else val
    if mode == OverflowMode.SAT_SMGN:
        lo = (-(1 << (w - 1)) + 1) if fmt.signed else 0
        return hi if val > hi else lo if val < lo else val
    if mode == OverflowMode.WRP_TCPL:
        if fmt.signed:
            m = val & ((1 << w) - 1)
            return m - (1 << w) if (m >> (w - 1)) & 1 else m
        # unsigned wrap masks to int_bits + frac_bits bits (QuBLAS.h:2329-2331)
        return val & ((1 << (w - 1)) - 1)
    if mode == OverflowMode.WRP_TCPL_SAT:
        # reference stub: intConvert returns the input unchanged
        # (QuBLAS.h:2336-2344), but the subsequent store into the target
        # ArbiInt wraps to its *machine word*: int32 for storage <= 32,
        # int64 for <= 64, the low 64*ceil(w/64) bits beyond (verified by
        # probe: Qmul<Qu<10,2,WRP::TCPL_SAT>> of a 61-bit product stores
        # -1709030993 = product mod 2^32 as int32)
        if w <= 32:
            word = 32
        elif w <= 64:
            word = 64
        else:
            word = 64 * ((w + 63) // 64)
        m = val & ((1 << word) - 1)
        return m - (1 << word) if (m >> (word - 1)) & 1 else m
    raise ValueError(f"unknown overflow mode {mode}")  # pragma: no cover


def requantize(val: int, from_frac: int, fmt: QFormat) -> int:
    """Full requantization pipeline: round (frac_convert) then saturate
    (int_convert) — the epilogue of every quantized op."""
    return int_convert(frac_convert(val, from_frac, fmt.frac_bits, fmt.round_mode), fmt)


def double_to_raw(x: float, fmt: QFormat) -> int:
    """Exact double → fixed-point raw integer.

    The reference converts through a 2400-bit buffer holding the double
    *exactly* at ``1200 + frac_bits`` fractional bits, then rounds and
    saturates per the declared modes (QuBLAS.h:2387-2393).  A Python int does
    the same with no width cap: 1200 fractional bits are enough for any
    finite double (subnormals bottom out at 2^-1074).
    """
    if x == 0.0 or math.isnan(x) or math.isinf(x):
        # loadFromDouble zeroes non-finite inputs (QuBLAS.h:451-455)
        return 0
    guard = 1200
    m, e = math.frexp(x)  # x = m * 2^e, 0.5 <= |m| < 1
    mant = int(m * (1 << 53))  # exact: doubles have 53-bit significands
    shift = e - 53 + guard + fmt.frac_bits
    if shift >= 0:
        wide = mant << shift
    else:
        wide = mant >> (-shift)  # only reachable for frac_bits < -1100
    return int_convert(
        frac_convert(wide, guard + fmt.frac_bits, fmt.frac_bits, fmt.round_mode),
        fmt,
    )


def reference_requant_defect(raw: int, src: QFormat, dst: QFormat) -> bool:
    """True when the reference's fracConvert/intConvert on THIS input hits
    the documented multiword defect classes (REFERENCE_DEFECTS.md D2/D3):

    * D2 — ``fracConvert<RND::CONV>`` with a multiword operand (source
      storage > 64 bits) corrupts negatives, exact ties, and values needing
      clamping (mixed-width mask arithmetic, QuBLAS.h:2125-2159).  Verified:
      ``Qu<70,70> raw=-2^31 → Qu<8,8,RND::CONV>`` yields 3 instead of 0.
    * D3 — saturation comparisons against multiword intermediates with
      pre-clamp magnitude ≥ 2^63 are unreliable.
    """
    if src.storage_bits <= 64:
        return False
    d = src.frac_bits - dst.frac_bits
    rounded = frac_convert(raw, src.frac_bits, dst.frac_bits, dst.round_mode)
    if dst.round_mode == RoundMode.RND_CONV and d > 0:
        dropped = raw & ((1 << d) - 1)
        tie = dropped == (1 << (d - 1))
        if raw < 0 or tie or int_convert(rounded, dst) != rounded:
            return True
    if abs(rounded) >= (1 << 63) and int_convert(rounded, dst) != rounded:
        return True
    return False


def reference_double_ctor_defect(x: float, fmt: QFormat) -> bool:
    """True when the reference's ``Qu_s(double)`` ctor hits a documented
    defect class for this input (REFERENCE_DEFECTS.md D2/D3), so its output
    is width-dependent garbage our exact implementation deliberately does
    not replicate.

    * D2 — RND::CONV on the multiword guard path corrupts every negative
      value (even exact ones — the floor computed through the mismatched
      mask loses the sign), positive exact ties, and any value that would
      need clamping (the wrap happens *before* the saturation compare, so
      e.g. ``Qu<8,8,RND::CONV>(123456.789)`` yields the rounded value
      mod 2^16 instead of saturating).
    * D3 — saturating conversions whose pre-clamp magnitude is ≥ 2^63 can
      fail the multiword bounds comparison.
    """
    if x == 0.0 or math.isnan(x) or math.isinf(x):
        return False
    guard = 1200
    m, e = math.frexp(x)
    mant = int(m * (1 << 53))
    shift = e - 53 + guard + fmt.frac_bits
    wide = mant << shift if shift >= 0 else mant >> (-shift)
    rounded = frac_convert(wide, guard + fmt.frac_bits, fmt.frac_bits,
                           fmt.round_mode)
    if fmt.round_mode == RoundMode.RND_CONV:
        dropped = wide & ((1 << guard) - 1)
        tie = dropped == (1 << (guard - 1))
        if wide < 0 or tie or int_convert(rounded, fmt) != rounded:
            return True
    if abs(rounded) >= (1 << 63) and int_convert(rounded, fmt) != rounded:
        return True
    return False


def raw_to_double(raw: int, fmt: QFormat) -> float:
    """Raw integer → double: ``raw / 2^frac_bits`` (QuBLAS.h:2413-2416)."""
    try:
        return math.ldexp(float(raw), -fmt.frac_bits)
    except OverflowError:
        return math.inf if raw > 0 else -math.inf


def trunc_div(a: int, b: int) -> int:
    """C++-style integer division: truncates toward zero.

    Python ``//`` floors; the reference's Qdiv inherits C++ ``/`` semantics
    (QuBLAS.h:3257).
    """
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q
