"""QuBLAS fixed-point semantics in plain PyTorch: the benchmark's reference.

Worked out from the QuBLAS reference's definitions (``include/QuBLAS.h``:
``fracConvert`` for the seven rounding modes, ``intConvert`` for the five
overflow modes, ``MulMerger``/``AddMerger`` for inferred formats, the
vector-path ``Reducer`` tree, and the ``Qtable`` ROM), on int64 tensors.
It imports nothing of the program under test and takes nothing it made:
formats are plain records read from a configuration file, ROMs are built
here from their function, and a GEMM is either an exact float64 product
(where this module proves every product and every tree layer lossless
from the formats alone) or the explicit tree over blocks of rows.

Every function also takes ``control=True``, the same arithmetic in the
next narrower precision: bfloat16 GEMMs for the exact (float32 and
wider) ones, int16 lanes for a tree whose formats need int32.  A
comparison that the control passes cannot tell right from wrong.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Optional, Sequence

import torch

ROUND_MODES = ("RND_POS_INF", "RND_NEG_INF", "RND_ZERO", "RND_INF",
               "RND_CONV", "TRN_TCPL", "TRN_SMGN")
OVERFLOW_MODES = ("SAT_TCPL", "SAT_ZERO", "SAT_SMGN", "WRP_TCPL",
                  "WRP_TCPL_SAT")
DEFAULT_ROUND, DEFAULT_OVERFLOW = "TRN_TCPL", "SAT_TCPL"

# rows of products held at once by the tree: [rows, n, k] int64
TREE_BLOCK_BYTES = 1 << 28


@dataclass(frozen=True)
class Fmt:
    """``Qu<int_bits, frac_bits, signed, round, overflow>``: raws are
    two's complement in ``1 + int_bits + frac_bits`` bits, whatever
    ``signed`` says; an unsigned format saturates at 0 from below."""

    int_bits: int
    frac_bits: int
    signed: bool = True
    round: str = DEFAULT_ROUND
    overflow: str = DEFAULT_OVERFLOW

    def __post_init__(self):
        if self.round not in ROUND_MODES:
            raise ValueError(f"unknown rounding mode {self.round!r}")
        if self.overflow not in OVERFLOW_MODES:
            raise ValueError(f"unknown overflow mode {self.overflow!r}")

    @classmethod
    def of(cls, spec: Optional[dict]) -> Optional["Fmt"]:
        """A format from a configuration's ``{"int_bits", "frac_bits",
        "signed", "round", "overflow"}`` (None stays None)."""
        if spec is None:
            return None
        return cls(spec["int_bits"], spec["frac_bits"],
                   spec.get("signed", True),
                   spec.get("round", DEFAULT_ROUND),
                   spec.get("overflow", DEFAULT_OVERFLOW))

    @property
    def bits(self) -> int:
        return 1 + self.int_bits + self.frac_bits

    @property
    def raw_max(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def raw_min(self) -> int:
        return -(1 << (self.bits - 1))

    @property
    def storage_bytes(self) -> int:
        """Bytes of the narrowest int8/16/32/64 lane that holds a raw."""
        return next(b for b in (1, 2, 4, 8) if 8 * b >= self.bits)


def merged(a: Fmt, b: Fmt, to: Optional[Fmt]) -> Fmt:
    """The format of a product or a sum of ``a`` and ``b`` (``MulMerger``,
    and ``AddMerger`` without FullPrec): ``to`` where given, else the
    larger int and frac bits, signed if either is, and the operands'
    modes where they agree, else the defaults."""
    if to is not None:
        return to
    return Fmt(max(a.int_bits, b.int_bits), max(a.frac_bits, b.frac_bits),
               a.signed or b.signed,
               a.round if a.round == b.round else DEFAULT_ROUND,
               a.overflow if a.overflow == b.overflow else DEFAULT_OVERFLOW)


# ---------------------------------------------------------------------------
# requantize: round (fracConvert), then saturate or wrap (intConvert)
# ---------------------------------------------------------------------------

def round_shift(v: torch.Tensor, from_frac: int, to_frac: int,
                mode: str) -> torch.Tensor:
    """``v`` (int64 raws at ``from_frac`` fractional bits) at ``to_frac``
    bits: exact when precision grows, else rounded by ``mode``."""
    d = from_frac - to_frac
    if d <= 0:
        return v << (-d)
    xh = v >> d                       # floor
    if mode == "TRN_TCPL":
        return xh
    if mode == "TRN_SMGN":            # toward zero
        return torch.where(v < 0, -((-v) >> d), xh)
    xl = v & ((1 << d) - 1)
    half = 1 << (d - 1)
    if mode == "RND_POS_INF":
        carry = xl >= half
    elif mode == "RND_NEG_INF":
        carry = xl > half
    elif mode == "RND_ZERO":
        carry = (xl > half) | ((xl == half) & (v < 0))
    elif mode == "RND_INF":
        carry = (xl > half) | ((xl == half) & (v > 0))
    else:                             # RND_CONV: half to even
        carry = (xl > half) | ((xl == half) & ((xh & 1) == 1))
    return xh + carry.to(v.dtype)


def saturate(v: torch.Tensor, fmt: Fmt) -> torch.Tensor:
    """``v`` into ``fmt``'s storage by its overflow mode."""
    w, hi = fmt.bits, fmt.raw_max
    lo = fmt.raw_min if fmt.signed else 0
    mode = fmt.overflow
    if mode == "SAT_TCPL":
        return v.clamp(lo, hi)
    if mode == "SAT_ZERO":
        return torch.where((v > hi) | (v < lo), torch.zeros_like(v), v)
    if mode == "SAT_SMGN":
        return v.clamp(lo + 1 if fmt.signed else 0, hi)
    if mode == "WRP_TCPL":
        return wrap(v, w) if fmt.signed else v & ((1 << (w - 1)) - 1)
    # WRP_TCPL_SAT: no overflow handling; the store wraps to the machine
    # word that holds the storage (32 or 64 bits here)
    return v if w > 32 else wrap(v, 32)


def wrap(v: torch.Tensor, bits: int) -> torch.Tensor:
    """``v`` as ``bits``-bit two's complement (bits < 64)."""
    m = v & ((1 << bits) - 1)
    return torch.where(m >= (1 << (bits - 1)), m - (1 << bits), m)


def requantize(v: torch.Tensor, from_frac: int, fmt: Fmt) -> torch.Tensor:
    return saturate(round_shift(v, from_frac, fmt.frac_bits, fmt.round),
                    fmt)


def double_to_raw(x: float, fmt: Fmt) -> int:
    """The exact double ``x`` as a raw of ``fmt``: rounded by its mode from
    the exact rational, then saturated; NaN and infinities give 0."""
    if not math.isfinite(x):
        return 0
    scaled = Fraction(x) * (Fraction(2) ** fmt.frac_bits)
    num, den = scaled.numerator, scaled.denominator
    # den is a power of two: one exact shift of the numerator
    d = den.bit_length() - 1
    xh, xl = num >> d, num & (den - 1)
    half = den >> 1
    mode = fmt.round
    if d == 0 or mode == "TRN_TCPL":
        q = xh
    elif mode == "TRN_SMGN":
        q = xh + (1 if num < 0 and xl else 0)
    elif mode == "RND_POS_INF":
        q = xh + (xl >= half)
    elif mode == "RND_NEG_INF":
        q = xh + (xl > half)
    elif mode == "RND_ZERO":
        q = xh + (xl > half or (xl == half and num < 0))
    elif mode == "RND_INF":
        q = xh + (xl > half or (xl == half and num > 0))
    else:
        q = xh + (xl > half or (xl == half and xh & 1 == 1))
    return int(saturate(torch.tensor([q], dtype=torch.int64), fmt)[0])


# ---------------------------------------------------------------------------
# ROMs (Qtable): every input bit pattern through a double function
# ---------------------------------------------------------------------------

ROM_FUNCTIONS = {
    "sqrt": lambda v: math.sqrt(v) if v >= 0 else math.nan,
}


def rom_table(func: str, in_fmt: Fmt, out_fmt: Fmt) -> torch.Tensor:
    """int64 entries indexed by the input's ``1 + int + frac``-bit (signed
    formats) pattern: entry p holds ``func`` of the raw that p encodes."""
    fn = ROM_FUNCTIONS[func]
    w = in_fmt.int_bits + in_fmt.frac_bits + int(in_fmt.signed)
    entries = []
    for p in range(1 << w):
        raw = p - (1 << w) if in_fmt.signed and p >= 1 << (w - 1) else p
        entries.append(double_to_raw(fn(raw / 2.0 ** in_fmt.frac_bits),
                                     out_fmt))
    return torch.tensor(entries, dtype=torch.int64)


def rom_lookup(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The entries of ``x``'s raws: each raw's low bits index the table."""
    return table.to(x.device)[x.long() & (table.numel() - 1)]


# ---------------------------------------------------------------------------
# GEMM: per-product requantize, the pairwise tree, the final conversion
# ---------------------------------------------------------------------------

def level_formats(prod: Fmt, add_formats: Sequence[Fmt], k: int):
    """The format of each of the tree's ceil(log2 k) levels: the layer's
    own (the last one repeats), or the merge of its operands."""
    fmts, cur, n, level = [], prod, k, 0
    while n > 1:
        own = add_formats[min(level, len(add_formats) - 1)] \
            if add_formats else None
        cur = merged(cur, cur, own)
        fmts.append((own, cur))
        n, level = (n + 1) // 2, level + 1
    return fmts


def lossless(fa: Fmt, fb: Fmt, prod: Fmt, levels, k: int) -> bool:
    """True where no product and no partial sum can round or overflow for
    any raws of ``fa`` and ``fb``, and float64 holds every sum exactly:
    then the tree's result is the exact dot product."""
    p_frac = fa.frac_bits + fb.frac_bits
    big = (1 << (fa.bits - 1)) * (1 << (fb.bits - 1))   # |a*b| at most
    fracs = [prod] + [f for _, f in levels]
    for f, g in zip(fracs, fracs[1:]):
        if g.frac_bits < f.frac_bits:
            return False
    if prod.frac_bits < p_frac:
        return False
    for f, most in zip(fracs, [big] + [big * k] * len(levels)):
        if not f.signed or most << (f.frac_bits - p_frac) > f.raw_max:
            return False
    return (big * k) < (1 << 53)


def gemm(a: torch.Tensor, b: torch.Tensor, fa: Fmt, fb: Fmt, out: Fmt,
         mul_to: Optional[Fmt] = None, add_formats: Sequence[Fmt] = (),
         control: bool = False) -> torch.Tensor:
    """``qgemul(a, b, out, mul_to, add_formats)`` on raws [m, k] @ [k, n]:
    int64 raws of ``out``."""
    k = a.shape[1]
    prod = merged(fa, fb, mul_to)
    levels = level_formats(prod, tuple(add_formats), k)
    p_frac = fa.frac_bits + fb.frac_bits
    if lossless(fa, fb, prod, levels, k):
        rows = max(TREE_BLOCK_BYTES // (8 * b.shape[1]), 1)
        dtype = torch.bfloat16 if control else torch.float64
        bd = b.to(dtype)
        parts = [requantize((a[i:i + rows].to(dtype) @ bd).double().round()
                            .long(), p_frac, out)
                 for i in range(0, a.shape[0], rows)]
    else:
        rows = max(TREE_BLOCK_BYTES // (8 * b.shape[1] * max(k, 1)), 1)
        bt = b.t().long()
        parts = [_tree(a[i:i + rows].long(), bt, p_frac, prod, levels, out,
                       control) for i in range(0, a.shape[0], rows)]
    return torch.cat(parts)


def _tree(a, bt, p_frac, prod, levels, out, control):
    narrow = (lambda v: wrap(v, 16)) if control else (lambda v: v)
    v = narrow(requantize(a[:, None, :] * bt[None, :, :], p_frac, prod))
    cur = prod
    for own, fmt in levels:
        n = v.shape[-1]
        s = v[..., 0:n - 1:2] + v[..., 1:n:2]
        s = narrow(requantize(s, cur.frac_bits, fmt))
        if n % 2:
            tail = v[..., n - 1:]
            if own is not None:
                tail = narrow(requantize(tail, cur.frac_bits, own))
            s = torch.cat([s, tail], dim=-1)
        v, cur = s, fmt
    return narrow(requantize(v[..., 0], cur.frac_bits, out))
