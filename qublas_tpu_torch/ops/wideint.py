"""Bit-exact requantize on int32 tensors: the lane fast path.

Plain-torch port of ``qublas_tpu.ops.wideint`` lines 335-465
(``_carry_mode``, ``_overflow_i32``, ``requantize_i32``,
``requantize_split_mul``).  These functions are also the reference
epilogue of the CUDA kernels, whose device copy is ``csrc/requant.cuh``;
``_overflow_i32`` alone is the overflow stage of ``qdiv``.

Two differences from the JAX version, both forced by torch on the CPU:

* torch has no uint32 comparison there, so ``SAT_ZERO``'s single unsigned
  range compare becomes two signed compares (the same predicate: ``y`` lies
  outside ``[lo, hi]``);
* shift amounts and masks are Python ints; torch's int32 ``>>`` is
  arithmetic and its ``+``, ``*`` and ``<<`` wrap, as the XLA lanes do.

Width contract as in the JAX package: the caller has proven (``widths``)
that every intermediate fits int32.
"""

from __future__ import annotations

import torch

from ..qformat import OverflowMode, QFormat, RoundMode

__all__ = ["requantize_i32", "requantize_split_mul", "_overflow_i32"]


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
