"""Bit-exact requantize on int32 and int64 tensors.

Plain-torch port of ``qublas_tpu.ops.wideint``: the lane fast path
(lines 335-465: ``_carry_mode``, ``_overflow_i32``, ``requantize_i32``,
``requantize_split_mul``) and the 64-bit pair path (``mul32_wide``,
``pair_div_trunc``, ``_round_pair``, ``requantize_pair_keep`` and
``requantize_pair``).  The JAX package emulates int64 as a (hi: int32,
lo: uint32) pair, since the TPU has no int64 lanes; torch has int64 on the
CPU and on CUDA, so the pair functions here keep the semantics and drop
the two-word layout.  These functions are also the reference epilogue of
the CUDA kernels, whose device copy is ``csrc/requant.cuh``;
``_overflow_i32`` alone is the overflow stage of the lane ``qdiv``.

Two differences from the JAX version, both forced by torch on the CPU:

* torch has no uint32 comparison there, so ``SAT_ZERO``'s single unsigned
  range compare becomes two signed compares (the same predicate: ``y`` lies
  outside ``[lo, hi]``);
* shift amounts and masks are Python ints; torch's int32 ``>>`` is
  arithmetic and its ``+``, ``*`` and ``<<`` wrap, as the XLA lanes do.

Width contract as in the JAX package: the caller has proven (``widths``)
that every intermediate fits int32 (lane functions) or int64 (``_i64``
functions).  Shift counts of 64 or more are clamped explicitly here:
torch's int64 shifts by such counts differ between the CPU and CUDA.
"""

from __future__ import annotations

import torch

from ..qformat import OverflowMode, QFormat, RoundMode

__all__ = ["requantize_i32", "requantize_split_mul", "_overflow_i32",
           "mul_wide", "div_trunc_i64", "requantize_i64"]

I64_MIN = -(1 << 63)


def _carry_mode(mode, xl_gt, xl_ge, xl_eq, is_neg, is_pos, xh_odd):
    """Rounding carry predicate (reference fracConvert, QuBLAS.h:2002-2159)."""
    if mode == RoundMode.RND_POS_INF:
        return xl_ge
    if mode == RoundMode.RND_NEG_INF:
        return xl_gt
    if mode == RoundMode.RND_ZERO:
        return xl_gt | (xl_eq & is_neg)
    if mode == RoundMode.RND_INF:
        return xl_gt | (xl_eq & is_pos)
    if mode == RoundMode.RND_CONV:
        return xl_gt | (xl_eq & xh_odd)
    raise AssertionError(mode)


def _overflow_i32(y: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """int_convert on an int32 value (result width <= 32 by width proof)."""
    w = fmt.storage_bits
    mode = fmt.overflow_mode
    if mode in (OverflowMode.SAT_TCPL, OverflowMode.SAT_ZERO,
                OverflowMode.SAT_SMGN):
        if w > 32:
            return y  # cannot overflow a 32-bit-wide intermediate
        hi_v = (1 << (w - 1)) - 1
        if not fmt.signed:
            lo_v = 0
        elif mode == OverflowMode.SAT_SMGN:
            lo_v = -(1 << (w - 1)) + 1
        else:
            lo_v = -(1 << (w - 1))
        if mode == OverflowMode.SAT_ZERO:
            return torch.where((y < lo_v) | (y > hi_v), torch.zeros_like(y), y)
        return torch.clamp(y, lo_v, hi_v)
    if mode == OverflowMode.WRP_TCPL:
        if fmt.signed:
            if w >= 32:
                return y
            mask = (1 << w) - 1
            m = y & mask
            sign = (m >> (w - 1)) & 1
            return torch.where(sign == 1, m | ~mask, m)
        wb = w - 1  # unsigned wrap masks to int_bits+frac_bits (QuBLAS.h:2329)
        if wb >= 32:
            return y
        return y & ((1 << wb) - 1)
    if mode == OverflowMode.WRP_TCPL_SAT:
        return y  # reference stub (QuBLAS.h:2336-2344)
    raise AssertionError(mode)


def requantize_i32(x: torch.Tensor, from_frac: int,
                   fmt: QFormat) -> torch.Tensor:
    """Bit-exact requantize of an int32 tensor from ``from_frac`` fractional
    bits into ``fmt`` (round, then overflow)."""
    mode = fmt.round_mode
    d = from_frac - fmt.frac_bits
    if d <= 0:
        y = x << (-d) if d else x
    elif mode == RoundMode.TRN_TCPL:
        y = x >> d
    elif mode == RoundMode.TRN_SMGN:
        # truncate toward zero via bias-add: the naive -((-x) >> d) wraps
        # at x = INT32_MIN
        y = (x + torch.where(x < 0, (1 << d) - 1, 0).to(x.dtype)) >> d
    else:
        if d > 31:
            # the width proof (route "i32") never admits it
            raise AssertionError("shift too wide for i32 path")
        xh = x >> d
        xl = x & ((1 << d) - 1)
        t = 1 << (d - 1)
        carry = _carry_mode(mode, xl > t, xl >= t, xl == t,
                            x < 0, x > 0, (xh & 1) == 1)
        y = xh + carry.to(x.dtype)
    return _overflow_i32(y, fmt)


def requantize_split_mul(a: torch.Tensor, b: torch.Tensor, from_frac: int,
                         fmt: QFormat) -> torch.Tensor:
    """Requantized product ``a * b`` of int32 tensors whose product may not
    fit int32, via the split-B trick (``bh = b >> d``, ``bl = b & (2^d-1)``;
    see ``qublas_tpu.ops.wideint.requantize_split_mul``).  Requires
    ``1 <= d <= 30`` and the ``widths.route_mul`` "split" proof."""
    mode = fmt.round_mode
    d = from_frac - fmt.frac_bits
    assert 1 <= d <= 30
    mask = (1 << d) - 1
    bl = b & mask
    bh = b >> d
    albl = a * bl
    xh = a * bh + (albl >> d)          # floor(prod / 2^d)
    if mode == RoundMode.TRN_TCPL:
        y = xh
    else:
        xl = albl & mask
        if mode == RoundMode.TRN_SMGN:
            neg = ((a ^ b) < 0) & (a != 0)
            y = xh + (neg & (xl != 0)).to(xh.dtype)
        else:
            t = 1 << (d - 1)
            nz = (a != 0) & (b != 0)
            is_neg = ((a ^ b) < 0) & nz
            is_pos = ((a ^ b) >= 0) & nz
            carry = _carry_mode(mode, xl > t, xl >= t, xl == t,
                                is_neg, is_pos, (xh & 1) == 1)
            y = xh + carry.to(xh.dtype)
    return _overflow_i32(y, fmt)


# ---------------------------------------------------------------------------
# The 64-bit pair path on int64 tensors
# ---------------------------------------------------------------------------

def mul_wide(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact product of int32 (or narrower) tensors as int64: the JAX
    package's ``mul32_wide``; ``pair_mul`` (low 64 bits of a 64 x 64
    product) is the same int64 multiply, which wraps."""
    return a.to(torch.int64) * b.to(torch.int64)


def div_trunc_i64(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """C++ ``/`` on int64 tensors, with the reference's division-by-zero
    wart: a zero divisor gives 0 (``pair_div_trunc`` and its caller's mask,
    QuBLAS.h:3252-3255).  ``INT64_MIN / -1`` wraps to ``INT64_MIN``, as the
    pair long division does.  Both are selected around before dividing:
    torch's CPU divide raises on a zero divisor and traps on the overflow,
    and its CUDA divide returns garbage there."""
    zero = den == 0
    trap = (num == I64_MIN) & (den == -1)
    q = torch.div(num, torch.where(zero | trap, 1, den),
                  rounding_mode="trunc")
    return torch.where(zero, 0, q)


def _shr(x: torch.Tensor, d: int) -> torch.Tensor:
    """Arithmetic right shift by ``d >= 0``; 63 already gives every int64
    its floor at any larger count."""
    return x >> min(d, 63)


def _round_i64(x: torch.Tensor, from_frac: int,
               fmt: QFormat) -> torch.Tensor:
    """The rounding stage (fracConvert, QuBLAS.h:2002-2204) on int64, as
    ``_round_pair`` computes it on (hi, lo) pairs.  ``TRN_SMGN`` negates,
    shifts and negates back, wrapping at ``INT64_MIN`` as the pair
    negation does."""
    mode = fmt.round_mode
    d = from_frac - fmt.frac_bits
    if d <= 0:
        return x << -d if -d < 64 else torch.zeros_like(x)
    if mode == RoundMode.TRN_TCPL:
        return _shr(x, d)
    if mode == RoundMode.TRN_SMGN:
        return torch.where(x < 0, -_shr(-x, d), _shr(x, d))
    xh = _shr(x, d)
    if d < 64:
        xl = x & ((1 << d) - 1)
        t = 1 << (d - 1)
        gt, eq = xl > t, xl == t
    else:
        # the low d bits of x as a non-negative number are x, or 2^d + x
        # for x < 0; the threshold 2^(d-1) is past every int64
        gt = (x < 0) & ((x != I64_MIN) if d == 64 else True)
        eq = (x == I64_MIN) if d == 64 else torch.zeros_like(gt)
    carry = _carry_mode(mode, gt, gt | eq, eq, x < 0, x > 0,
                        (xh & 1) == 1)
    return xh + carry.to(torch.int64)


def requantize_i64(x: torch.Tensor, from_frac: int,
                   fmt: QFormat) -> torch.Tensor:
    """Bit-exact requantize of an int64 tensor from ``from_frac``
    fractional bits into ``fmt`` (round, then overflow, both on int64), as
    an int64 raw: ``requantize_pair_keep`` for a pair-storage ``fmt``.  For
    a lane ``fmt`` the low 32 bits of the result are ``requantize_pair``'s
    (narrow with ``.to(torch.int32)``).  ``WRP_TCPL_SAT`` wraps at the
    64-bit word.  The caller has proven that ``x`` and every rounding
    intermediate fit int64."""
    y = _round_i64(x.to(torch.int64), from_frac, fmt)
    w = fmt.storage_bits
    mode = fmt.overflow_mode
    if mode in (OverflowMode.SAT_TCPL, OverflowMode.SAT_ZERO,
                OverflowMode.SAT_SMGN):
        hi_v = (1 << (w - 1)) - 1
        if not fmt.signed:
            lo_v = 0
        elif mode == OverflowMode.SAT_SMGN:
            lo_v = -hi_v
        else:
            lo_v = -(1 << (w - 1))
        out = (y < lo_v) | (y > hi_v)
        if mode == OverflowMode.SAT_ZERO:
            return torch.where(out, 0, y)
        return torch.where(y < lo_v, lo_v, torch.where(y > hi_v, hi_v, y))
    if mode == OverflowMode.WRP_TCPL:
        if fmt.signed:
            if w >= 64:
                return y
            mask = (1 << w) - 1
            m = y & mask
            return torch.where(((m >> (w - 1)) & 1) == 1, m | ~mask, m)
        wb = w - 1  # unsigned wrap masks to int_bits+frac_bits (QuBLAS.h:2329)
        return y if wb >= 64 else y & ((1 << wb) - 1)
    if mode == OverflowMode.WRP_TCPL_SAT:
        return y  # reference stub (QuBLAS.h:2336-2344); wraps at the word
    raise AssertionError(mode)
