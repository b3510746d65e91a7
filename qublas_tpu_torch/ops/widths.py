"""Width proofs and storage dtypes of formats on torch tensors.

The interval proofs (``Interval``, ``fmt_interval``, ``route_requant``,
``route_mul``, ...) are the port's own copy of ``qublas_tpu/ops/widths.py``,
pinned to it by ``tests/test_torch_copies.py``.  They decide, per op
configuration and before any data is touched, which lane strategy keeps the
arithmetic exact:

* ``i32``   — every intermediate fits one int32 lane (``split`` is the
  int32 split-B product of a wider multiply),
* ``pair``  — 64-bit intermediates, on int64 tensors (:mod:`.wideint`),
* ``limb``  — stacked 32-bit limbs (:mod:`.limbint`, working widths up to
  1,024 bits),
* ``host``  — the exact Python-int golden model (:mod:`..hostops`).

The proof is exact interval arithmetic over Python ints.  Raw values are
assumed to lie within their format's storage range, as the reference
assumes (QuBLAS.h:341); ``from_raw`` can violate it (the ``fill(int)``
wart).  The dtype rules are :func:`torch_dtype_for` (lanes only) and
:func:`storage_dtype` (lanes and pairs); :func:`limb_count` gives the limbs
of limb storage.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..qformat import OverflowMode, QFormat

__all__ = ["torch_dtype_for", "storage_dtype", "LANE_DTYPES", "Interval",
           "fmt_interval", "rounded_interval", "requant_out_interval",
           "route_requant", "requant_work_bits", "split_mul_ok", "route_mul",
           "route_addsub", "route_div", "storage_kind", "limb_count"]

LANE_DTYPES = (torch.int8, torch.int16, torch.int32)


def torch_dtype_for(fmt: QFormat):
    """Smallest single-lane torch dtype holding the format's storage, or
    None when the format needs pair/limb/host storage.

    WRP_TCPL_SAT formats wrap only at the machine word, so their lane is
    always a full int32 word (narrower dtypes would wrap too early).
    """
    s = fmt.storage_bits
    if fmt.overflow_mode == OverflowMode.WRP_TCPL_SAT:
        return torch.int32 if s <= 32 else None
    if s <= 8:
        return torch.int8
    if s <= 16:
        return torch.int16
    if s <= 32:
        return torch.int32
    return None


def storage_dtype(fmt: QFormat):
    """The torch dtype of the format's storage: its lane dtype
    (:func:`torch_dtype_for`), ``torch.int64`` for pair storage (33..64
    bits), None for limb and host storage.

    The int32 kernels keep pair formats out by :func:`torch_dtype_for`,
    which stays None for them."""
    kind = storage_kind(fmt)
    if kind == "lane":
        return torch_dtype_for(fmt)
    return torch.int64 if kind == "pair" else None


I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
# one spare value on the negative side so pair negation (for TRN_SMGN) can
# never overflow the 64-bit emulation
I64_MIN, I64_MAX = -(1 << 63) + 1, (1 << 63) - 1

# limb storage envelope: formats up to 992-bit physical storage are held as
# stacked 32-bit limbs; op intermediates may use working widths up to 1024
# bits, and each op's own width proof decides limb vs host per config.
LIMB_STORE_MAX_BITS = 992
LIMB_INTER_MAX_BITS = 1024


@dataclass(frozen=True)
class Interval:
    lo: int
    hi: int

    def __mul__(self, o: "Interval"):
        c = (self.lo * o.lo, self.lo * o.hi, self.hi * o.lo, self.hi * o.hi)
        return Interval(min(c), max(c))

    def __add__(self, o: "Interval"):
        return Interval(self.lo + o.lo, self.hi + o.hi)

    def __sub__(self, o: "Interval"):
        return Interval(self.lo - o.hi, self.hi - o.lo)

    def __lshift__(self, s: int):
        return Interval(self.lo << s, self.hi << s)

    def fits(self, lo: int, hi: int) -> bool:
        return self.lo >= lo and self.hi <= hi

    @property
    def fits32(self):
        return self.fits(I32_MIN, I32_MAX)

    @property
    def fits64(self):
        return self.fits(I64_MIN, I64_MAX)

    @property
    def bits(self) -> int:
        """Signed two's-complement bits needed for every value in the
        interval, plus one spare value of negation headroom (mirrors the
        I64_MIN+1 margin of the pair path)."""
        need = 1
        for v in (self.lo, self.hi):
            w = (v.bit_length() + 1) if v >= 0 else ((-v).bit_length() + 1)
            need = max(need, w)
        return need


def fmt_interval(fmt: QFormat) -> Interval:
    """Raw-value interval of a format's physical storage.

    WRP_TCPL_SAT formats (the reference's identity stub) hold values wrapped
    only to the storage *machine word* — int32 for storage <= 32 bits — so
    their interval is the full word range, not the declared width.
    """
    if fmt.overflow_mode == OverflowMode.WRP_TCPL_SAT:
        if fmt.storage_bits <= 32:
            return Interval(I32_MIN, I32_MAX)
        word = 64 if fmt.storage_bits <= 64 else \
            64 * ((fmt.storage_bits + 63) // 64)
        return Interval(-(1 << (word - 1)), (1 << (word - 1)) - 1)
    return Interval(fmt.raw_min, fmt.raw_max)


def rounded_interval(iv: Interval, from_frac: int, fmt: QFormat):
    """Interval after frac_convert (conservative but tight) plus the list of
    intermediate intervals that must also fit the lane."""
    d = from_frac - fmt.frac_bits
    if d <= 0:
        out = iv << (-d)
        return out, [out]
    # right shift with worst-case +1 carry
    out = Interval(iv.lo >> d, (iv.hi >> d) + 1)
    return out, [iv, out]


def requant_out_interval(iv: Interval, from_frac: int, fmt: QFormat):
    """Interval after the full requantize (round + overflow)."""
    rounded, intermediates = rounded_interval(iv, from_frac, fmt)
    if fmt.overflow_mode == OverflowMode.WRP_TCPL_SAT:
        # identity stub + machine-word wrap at the store
        word_iv = fmt_interval(fmt)
        out = rounded if (rounded.lo >= word_iv.lo
                          and rounded.hi <= word_iv.hi) else word_iv
    elif fmt.overflow_mode == OverflowMode.WRP_TCPL:
        # wrap is NOT a clamp: any overflowing side can land anywhere in
        # the format range, so the sound interval is identity-if-contained
        # else the full range (an intersection under-approximates and
        # would unsoundly pass downstream fits32/limb-width proofs)
        lo = fmt.raw_min if fmt.signed else 0
        out = rounded if (rounded.lo >= lo and rounded.hi <= fmt.raw_max) \
            else Interval(lo, fmt.raw_max)
    else:
        # SAT modes: a true clamp
        out = Interval(max(rounded.lo, fmt.raw_min),
                       min(rounded.hi, fmt.raw_max))
        if not fmt.signed:
            out = Interval(max(out.lo, 0), max(out.hi, 0))
    return out, intermediates


def _shift_ok(from_frac: int, fmt: QFormat, limit: int) -> bool:
    d = from_frac - fmt.frac_bits
    return d <= limit


def route_requant(iv: Interval, from_frac: int, fmt: QFormat) -> str:
    """Pick the lane strategy for a requantize of values in ``iv``.

    "i32" also requires the *output* to fit one int32 lane; "pair" covers
    both int32-storable results computed through 64-bit intermediates and
    results stored as (hi, lo) limb pairs (storage 33..64 — see
    :func:`storage_kind`); "limb" computes through stacked N-limb uint32
    intermediates (65..1024-bit working widths) into any device storage
    kind; beyond that -> "host".
    """
    out, inters = requant_out_interval(iv, from_frac, fmt)
    all_iv = inters + [out]
    kind = storage_kind(fmt)
    if all(v.fits32 for v in all_iv) and _shift_ok(from_frac, fmt, 31) \
            and kind == "lane":
        return "i32"
    if all(v.fits64 for v in all_iv) and _shift_ok(from_frac, fmt, 63) \
            and kind in ("lane", "pair"):
        return "pair"
    if kind is not None and requant_work_bits(iv, from_frac, fmt) \
            <= LIMB_INTER_MAX_BITS:
        return "limb"
    return "host"


def requant_work_bits(iv: Interval, from_frac: int, fmt: QFormat) -> int:
    """Working width (bits) the limb requantize needs for values in ``iv``:
    every rounding intermediate, the 2^(d-1) tie threshold, and one bit of
    negation headroom (TRN_SMGN negates)."""
    _out, inters = requant_out_interval(iv, from_frac, fmt)
    d = from_frac - fmt.frac_bits
    need = max(v.bits for v in inters + [_out])
    if d > 0:
        need = max(need, d + 2)
    # the overflow stage materializes CONSTANTS in the working width —
    # saturation bounds 2^(w-1)-1 / -(2^(w-1)), wrap masks and the
    # -(2^wb) sign-extension addend — which can be wider than the value
    # interval when the destination is wider than the source
    need = max(need, fmt.storage_bits + 2)
    return need


def split_mul_ok(fa: QFormat, fb: QFormat, out: QFormat) -> bool:
    """True when the split-B int32 product trick applies (see
    ``.wideint.requantize_split_mul``): the requantization drops d in [1, 30]
    bits and a*(b & (2^d-1)), a*(b >> d), and the rounded value all fit
    int32 lanes."""
    d = fa.frac_bits + fb.frac_bits - out.frac_bits
    if not 1 <= d <= 30:
        return False
    ia, ib = fmt_interval(fa), fmt_interval(fb)
    bl = Interval(0, (1 << d) - 1)
    bh = Interval(ib.lo >> d, ib.hi >> d)
    albl = ia * bl
    abh = ia * bh
    if not (albl.fits32 and abh.fits32):
        return False
    # xh + rounding carry
    prod = ia * ib
    rounded = Interval((prod.lo >> d), (prod.hi >> d) + 1)
    return (abh + Interval(albl.lo >> d, albl.hi >> d)).fits32 \
        and rounded.fits32


def route_mul(fa: QFormat, fb: QFormat, out: QFormat):
    """Route + product interval for a quantized multiply.

    Routes: "i32" (single lane), "split" (int32 split-B product — cheaper
    than the 64-bit pair emulation), "pair", "host".
    """
    prod = fmt_interval(fa) * fmt_interval(fb)
    from_frac = fa.frac_bits + fb.frac_bits
    r = route_requant(prod, from_frac, out)
    if r == "i32" and not prod.fits32:
        r = "pair"  # the product itself needs 64-bit even if the shift fits
    if r == "pair" and not prod.fits64:
        r = "limb"
    if r == "limb" and (storage_kind(fa) is None or storage_kind(fb) is None
                        or max(prod.bits,
                               requant_work_bits(prod, from_frac, out))
                        > LIMB_INTER_MAX_BITS):
        r = "host"
    if r == "pair" and storage_kind(out) == "lane" \
            and storage_kind(fa) == "lane" and storage_kind(fb) == "lane" \
            and split_mul_ok(fa, fb, out):
        r = "split"  # needs single-lane operands (pair storage can't _load_i32)
    return r, prod, from_frac


def route_addsub(fa: QFormat, fb: QFormat, out: QFormat, sub: bool):
    """Route an aligned add/sub.  Returns (route, sum_iv, common_frac,
    ia, ib) — the shifted operand intervals are returned so the device
    path sizes its limb working width from the SAME proof inputs that
    picked the route."""
    f = max(fa.frac_bits, fb.frac_bits)
    ia = fmt_interval(fa) << (f - fa.frac_bits)
    ib = fmt_interval(fb) << (f - fb.frac_bits)
    s = (ia - ib) if sub else (ia + ib)
    r = route_requant(s, f, out)
    for iv in (ia, ib, s):
        if r == "i32" and not iv.fits32:
            r = "pair"
    for iv in (ia, ib, s):
        if r == "pair" and not iv.fits64:
            r = "limb"
    if r == "limb" and (storage_kind(fa) is None or storage_kind(fb) is None
                        or max(ia.bits, ib.bits, s.bits,
                               requant_work_bits(s, f, out))
                        > LIMB_INTER_MAX_BITS):
        r = "host"
    return r, s, f, ia, ib


def route_div(fa: QFormat, fb: QFormat, out: QFormat):
    """Pick the device route for a quantized divide: "i32" (an int32
    truncating divide), "pair" (64-bit long division), "limb" (bit-serial
    division on stacked limbs), or "host".  Returns ``(route, num_iv, den_iv)`` so the device path sizes its
    working width from the SAME proof intervals that picked the route."""
    shift_a = max(fb.frac_bits - fa.frac_bits, 0)
    shift_b = max(fa.frac_bits - fb.frac_bits, 0)
    num = fmt_interval(fa) << (shift_a + max(out.frac_bits, 0))
    den = fmt_interval(fb) << shift_b
    # quotient magnitude is bounded by the numerator's
    if out.frac_bits < 0:
        return "host", num, den
    quot = Interval(-max(abs(num.lo), abs(num.hi)), max(abs(num.lo), abs(num.hi)))
    ok32 = num.fits32 and den.fits32 and quot.fits32
    out_iv, _ = requant_out_interval(quot, out.frac_bits, out)
    if ok32 and out_iv.fits32 and storage_kind(out) == "lane" \
            and storage_kind(fa) == "lane" and storage_kind(fb) == "lane":
        return "i32", num, den
    # pair regime: numerator/denominator/quotient in the signed 64-bit
    # domain (with the I64_MIN+1 negation margin) and an epilogue that
    # runs there too — the divide itself has no rounding stage, so the
    # requantize route is checked at d == 0 (overflow stage only)
    if num.fits64 and den.fits64 and quot.fits64 \
            and storage_kind(fa) in ("lane", "pair") \
            and storage_kind(fb) in ("lane", "pair") \
            and route_requant(quot, out.frac_bits, out) in ("i32", "pair"):
        return "pair", num, den
    # limb regime: any device storage kind, working widths (incl. the
    # restoring remainder's 2*|den| bound — covered by Interval.bits'
    # negation-headroom bit) inside the 1024-bit envelope, and an
    # overflow-only epilogue that itself admits a device route
    if storage_kind(fa) is not None and storage_kind(fb) is not None \
            and max(num.bits, den.bits, quot.bits,
                    requant_work_bits(quot, out.frac_bits, out)) \
            <= LIMB_INTER_MAX_BITS \
            and route_requant(quot, out.frac_bits, out) != "host":
        return "limb", num, den
    return "host", num, den


def storage_kind(fmt: QFormat):
    """Storage class of a format:

    * ``"lane"`` — one int8/int16/int32 lane per element (storage <= 32),
    * ``"pair"`` — one int64 per element (storage 33..64; reference
      multiword ``ArbiInt``, QuBLAS.h:566-912; the JAX package's (hi, lo)
      pair),
    * ``"limb"`` — stacked 32-bit limbs in int64 (storage 65..992,
      :class:`~qublas_tpu_torch.ops.limbint.LimbArray`),
    * ``None``  — wider still: host-side Python-int object arrays (not yet
      ported: ROADMAP A4b).

    For WRP_TCPL_SAT (the reference identity stub) storage is the machine
    word: the int32 word up to 32 bits, the 64-bit pair up to 64 bits, a
    64-bit-multiple limb count beyond (:func:`limb_count`).
    """
    s = fmt.storage_bits
    if s <= 32:
        return "lane"
    if s <= 64:
        return "pair"
    if s <= LIMB_STORE_MAX_BITS:
        return "limb"
    return None


def limb_count(fmt: QFormat) -> int:
    """Stacked-limb count of a "limb"-storage format: ceil(storage/32),
    except WRP_TCPL_SAT, whose store wraps at the 64-bit-multiple machine
    word (copy of ``qublas_tpu/ops/widths.py:limb_count``)."""
    s = fmt.storage_bits
    if fmt.overflow_mode == OverflowMode.WRP_TCPL_SAT:
        return 2 * ((s + 63) // 64)
    return (s + 31) // 32
