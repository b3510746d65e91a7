"""Exact N-limb integers beyond 64 bits, on torch tensors.

Port of ``qublas_tpu/ops/limbint.py``.  A value is K little-endian 32-bit
limbs of its two's complement over ``32*K`` bits, stacked on a **leading**
axis ``(K, *elem_shape)``, as in the JAX package, so that limb counts and
the 992/1,024-bit envelope of :mod:`.widths` decide exactly as there.  Each
limb is held in an **int64** tensor with its value in ``[0, 2^32)``: torch
has no uint32 add, shift or compare on the CPU, and int64 leaves room for a
carry (a limb sum plus its carry stays below 2^34).  Hence:

* a carry is ``t >> 32`` and a limb ``t & 0xFFFFFFFF``; ``>>`` of a limb is
  logical, since the limb is non-negative;
* a 32 x 32-bit product would pass int64, so :func:`lmul` multiplies 16-bit
  digits, as the JAX package does on uint32;
* :func:`ldiv_trunc`'s loop over the numerator's bits is a Python loop of
  whole-tensor steps.

The functions run on the tensors' own device as plain torch ops, as the
JAX package's run as XLA ops.  Width contract as there: callers prove by
:mod:`.widths` that every value and intermediate fits the working limb
count ``K``; the requantize epilogue proves its own output fits the
destination's storage.
"""

from __future__ import annotations

import numpy as np
import torch

from ..qformat import OverflowMode, QFormat, RoundMode
from .wideint import _carry_mode

__all__ = [
    "LimbArray", "limbs_from_ints", "ints_from_limbs", "limbs_from_i64",
    "lext", "ladd", "lsub", "lneg", "lmul", "lshl", "lshr", "llow_bits",
    "llt", "lltu", "ldiv_trunc", "leq", "lis_neg", "lis_pos", "lconst",
    "lto_i32", "lto_i64", "lselect", "lbroadcast_elem", "requantize_limb",
    "store_limbs", "bits_to_limbs",
]

M32 = 0xFFFFFFFF


def bits_to_limbs(bits: int) -> int:
    """Limbs needed for a signed two's-complement value of ``bits`` bits."""
    return max((bits + 31) // 32, 1)


class LimbArray:
    """Limb storage of a QTensor (formats of 65..992 storage bits): a
    ``(K, *shape)`` int64 tensor of 32-bit limbs.  Indexing, reshapes and
    transposes act on the element dims; the limb axis stays first."""

    __slots__ = ("limbs",)

    def __init__(self, limbs: torch.Tensor):
        if limbs.dtype != torch.int64 or limbs.ndim < 1:
            raise TypeError(f"limbs must be a (K, ...) int64 tensor, got "
                            f"{limbs.dtype} of {limbs.ndim} dims")
        self.limbs = limbs

    @property
    def nlimbs(self) -> int:
        return self.limbs.shape[0]

    @property
    def shape(self):
        return tuple(self.limbs.shape[1:])

    @property
    def ndim(self) -> int:
        return self.limbs.ndim - 1

    @property
    def device(self) -> torch.device:
        return self.limbs.device

    def numel(self) -> int:
        return self.limbs[0].numel()

    def to(self, device) -> "LimbArray":
        return LimbArray(self.limbs.to(device))

    def __getitem__(self, idx) -> "LimbArray":
        if not isinstance(idx, tuple):
            idx = (idx,)
        return LimbArray(self.limbs[(slice(None),) + idx])

    def reshape(self, *shape) -> "LimbArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return LimbArray(self.limbs.reshape((self.nlimbs,) + tuple(shape)))

    def _dim(self, d: int) -> int:
        return d % self.ndim + 1

    def transpose(self, a: int, b: int) -> "LimbArray":
        return LimbArray(self.limbs.transpose(self._dim(a), self._dim(b)))

    def movedim(self, src: int, dst: int) -> "LimbArray":
        return LimbArray(torch.movedim(self.limbs, self._dim(src),
                                       self._dim(dst)))

    def select(self, dim: int, index: int) -> "LimbArray":
        return LimbArray(self.limbs.select(self._dim(dim), index))

    def to_numpy_ints(self) -> np.ndarray:
        """Object ndarray of the signed Python ints."""
        return ints_from_limbs(self.limbs)

    def __repr__(self):
        return (f"LimbArray(nlimbs={self.nlimbs}, shape={self.shape}, "
                f"device={self.device})")


def limbs_from_ints(values, K: int, device="cpu") -> torch.Tensor:
    """Python ints (any array-like) -> ``(K, *shape)`` limbs on ``device``.

    Values must fit ``32*K`` bits signed (``int.to_bytes`` raises
    OverflowError otherwise; callers check first)."""
    arr = np.asarray(values, dtype=object)
    buf = b"".join(int(v).to_bytes(4 * K, "little", signed=True)
                   for v in arr.reshape(-1))
    flat = np.frombuffer(buf, dtype=np.uint32).reshape(-1, K)
    stacked = np.ascontiguousarray(flat.T).astype(np.int64)
    return torch.from_numpy(stacked.reshape((K,) + arr.shape)).to(device)


def ints_from_limbs(limbs: torch.Tensor) -> np.ndarray:
    """``(K, *shape)`` limbs -> object ndarray of signed Python ints."""
    arr = limbs.cpu().numpy().astype(np.uint32)
    K, shape = arr.shape[0], arr.shape[1:]
    raw = np.ascontiguousarray(arr.reshape(K, -1).T).tobytes()
    nbytes = 4 * K
    n = len(raw) // nbytes
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = int.from_bytes(raw[i * nbytes:(i + 1) * nbytes], "little",
                                signed=True)
    return out.reshape(shape)


def limbs_from_i64(x: torch.Tensor, K: int) -> torch.Tensor:
    """Sign-extended ``(K, ...)`` limbs of an integer tensor (lanes, or the
    int64 of pair storage)."""
    x = x.to(torch.int64)
    return lext(torch.stack([x & M32, (x >> 32) & M32]), K)


def _top_signed(x: torch.Tensor) -> torch.Tensor:
    """The top limb as a signed 32-bit value."""
    top = x[-1]
    return top - ((top >> 31) << 32)


def _sign_fill(x: torch.Tensor) -> torch.Tensor:
    """An all-ones limb where the value is negative, zero elsewhere."""
    return (x[-1] >> 31) * M32


def lext(x: torch.Tensor, K: int) -> torch.Tensor:
    """Sign-extend (or truncate) stacked limbs to exactly K limbs."""
    kin = x.shape[0]
    if K == kin:
        return x
    if K < kin:
        return x[:K]
    fill = _sign_fill(x)[None].expand((K - kin,) + tuple(x.shape[1:]))
    return torch.cat([x, fill], dim=0)


def lconst(c: int, K: int, shape=(), device="cpu") -> torch.Tensor:
    """Python int -> broadcast constant limbs (mod 2^(32K))."""
    c &= (1 << (32 * K)) - 1
    col = torch.tensor([(c >> (32 * i)) & M32 for i in range(K)],
                       dtype=torch.int64, device=device)
    return col.reshape((K,) + (1,) * len(shape)).expand(
        (K,) + tuple(shape))


def ladd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact add mod 2^(32K) (ripple carry; K is static and small)."""
    out = []
    carry = None
    for i in range(a.shape[0]):
        t = a[i] + b[i] if carry is None else a[i] + b[i] + carry
        out.append(t & M32)
        carry = t >> 32
    return torch.stack(out)


def lneg(a: torch.Tensor) -> torch.Tensor:
    """Two's-complement negation mod 2^(32K)."""
    out = []
    carry = 1
    for i in range(a.shape[0]):
        t = (M32 - a[i]) + carry
        out.append(t & M32)
        carry = t >> 32
    return torch.stack(out)


def lsub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact subtract mod 2^(32K) (ripple borrow: the JAX package's
    ``ladd(a, lneg(b))``, in one pass)."""
    out = []
    borrow = None
    for i in range(a.shape[0]):
        t = a[i] - b[i] if borrow is None else a[i] - b[i] - borrow
        out.append(t & M32)
        borrow = (t >> 32) & 1
    return torch.stack(out)


def lselect(cond: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """Per-element select between two stacked-limb tensors."""
    return torch.where(cond[None], a, b)


def lbroadcast_elem(x: torch.Tensor, shape) -> torch.Tensor:
    """Broadcast the element dims of stacked limbs to ``shape`` (the limb
    axis leads, so right-aligned broadcasting between stacked tensors of
    different element ranks would misalign it)."""
    K = x.shape[0]
    pad = len(shape) - (x.ndim - 1)
    x = x.reshape((K,) + (1,) * pad + tuple(x.shape[1:]))
    return x.expand((K,) + tuple(shape))


def lshl(x: torch.Tensor, d: int) -> torch.Tensor:
    """Static left shift mod 2^(32K)."""
    if d == 0:
        return x
    K = x.shape[0]
    D, b = d // 32, d % 32
    zero = torch.zeros_like(x[0])
    out = []
    for i in range(K):
        if i < D:
            out.append(zero)
            continue
        v = (x[i - D] << b) & M32 if b else x[i - D]
        if b and i - D - 1 >= 0:
            v = v | (x[i - D - 1] >> (32 - b))
        out.append(v)
    return torch.stack(out)


def lshr(x: torch.Tensor, d: int) -> torch.Tensor:
    """Static arithmetic (sign-propagating) right shift."""
    if d == 0:
        return x
    K = x.shape[0]
    D, b = d // 32, d % 32
    fill = _sign_fill(x)
    out = []
    for i in range(K):
        src = i + D
        v = x[src] if src < K else fill
        nxt = x[src + 1] if src + 1 < K else fill
        out.append((v >> b) | ((nxt << (32 - b)) & M32) if b else v)
    return torch.stack(out)


def llow_bits(x: torch.Tensor, d: int) -> torch.Tensor:
    """val & (2^d - 1) as (non-negative) stacked limbs, 0 <= d < 32K."""
    K = x.shape[0]
    D, b = d // 32, d % 32
    zero = torch.zeros_like(x[0])
    out = []
    for i in range(K):
        if i < D:
            out.append(x[i])
        elif i == D and b:
            out.append(x[i] & ((1 << b) - 1))
        else:
            out.append(zero)
    return torch.stack(out)


def lltu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b (lexicographic over the limbs)."""
    K = a.shape[0]
    res = a[K - 1] < b[K - 1]
    eq = a[K - 1] == b[K - 1]
    for i in range(K - 2, -1, -1):
        res = res | (eq & (a[i] < b[i]))
        eq = eq & (a[i] == b[i])
    return res


def llt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Signed a < b (top limb signed, lower limbs unsigned
    lexicographic)."""
    K = a.shape[0]
    res = _top_signed(a) < _top_signed(b)
    eq = a[K - 1] == b[K - 1]
    for i in range(K - 2, -1, -1):
        res = res | (eq & (a[i] < b[i]))
        eq = eq & (a[i] == b[i])
    return res


def leq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def lis_neg(a: torch.Tensor) -> torch.Tensor:
    return a[-1] >= (1 << 31)


def lis_pos(a: torch.Tensor) -> torch.Tensor:
    return (a != 0).any(dim=0) & ~lis_neg(a)


def lto_i32(a: torch.Tensor) -> torch.Tensor:
    """Truncate to int32 (the caller guarantees the value fits)."""
    lo = a[0]
    return (lo - ((lo >> 31) << 32)).to(torch.int32)


def lto_i64(a: torch.Tensor) -> torch.Tensor:
    """Truncate to int64, the pair storage word (the value fits, or the
    format's machine-word wrap is the truncation)."""
    a = lext(a, 2)
    hi = _top_signed(a)
    return (hi << 32) | a[0]


def ldiv_trunc(a: torch.Tensor, b: torch.Tensor, nbits: int) -> torch.Tensor:
    """C++-style truncating division of signed stacked-limb values (the
    limb route of Qdiv, ``widths.route_div``; reference Qdiv semantics per
    REFERENCE_DEFECTS D1).

    Restoring long division on magnitudes: the numerator's magnitude is
    proven ``< 2**nbits`` by the caller's width proof, and
    ``Interval.bits``' bit of negation headroom keeps the shifted remainder
    ``R<<1 | bit < 2*|b|`` inside the limbs.  ``nbits`` shift, compare and
    subtract steps run as a Python loop of whole-tensor steps; the compare
    is the borrow out of the trial subtraction.  The quotient takes the XOR
    sign (truncation toward zero, exactly C++ ``/``).

    Division by zero returns an all-ones magnitude pattern (every trial
    subtraction succeeds); the caller masks it to the reference's zero
    wart.
    """
    K = a.shape[0]
    assert 0 < nbits <= 32 * K
    neg_a = lis_neg(a)
    neg_b = lis_neg(b)
    ua = lselect(neg_a, lneg(a), a)
    ub = lselect(neg_b, lneg(b), b)
    # the numerator's nbits window at the top: each step shifts one bit out
    x = lshl(ua, 32 * K - nbits)
    r = torch.zeros_like(ua)
    q = torch.zeros_like(ua)
    for _ in range(nbits):
        bit = x[K - 1] >> 31
        x = lshl(x, 1)
        r = lshl(r, 1)
        r[0] |= bit
        trial = []
        borrow = None
        for i in range(K):
            t = r[i] - ub[i] if borrow is None else r[i] - ub[i] - borrow
            trial.append(t & M32)
            borrow = (t >> 32) & 1
        ge = borrow == 0
        r = lselect(ge, torch.stack(trial), r)
        q = lshl(q, 1)
        q[0] |= ge.to(torch.int64)
    return lselect(neg_a != neg_b, lneg(q), q)


def lmul(a: torch.Tensor, b: torch.Tensor, K: int) -> torch.Tensor:
    """Exact signed product mod 2^(32K) of two stacked-limb values.

    Sign-extends both operands to K limbs, then unsigned schoolbook over
    16-bit digits: each digit product is below 2^32, and a column of at
    most 2K of them stays below 2^38 in int64, so the columns sum whole and
    one carry pass normalizes them.  Exact two's complement whenever the
    true product fits 32K bits, which the caller proves."""
    a = lext(a, K)
    b = lext(b, K)
    D = 2 * K
    da = torch.stack([a & 0xFFFF, a >> 16], dim=1).reshape(
        (D,) + tuple(a.shape[1:]))
    db = torch.stack([b & 0xFFFF, b >> 16], dim=1).reshape(
        (D,) + tuple(b.shape[1:]))
    cols = torch.zeros_like(da)
    for i in range(D):
        cols[i:] += da[i] * db[:D - i]
    digits = []
    carry = None
    for j in range(D):
        s = cols[j] if carry is None else cols[j] + carry
        digits.append(s & 0xFFFF)
        carry = s >> 16
    return torch.stack([digits[2 * i] | (digits[2 * i + 1] << 16)
                        for i in range(K)])


# ---------------------------------------------------------------------------
# Requantization epilogue (fracConvert + intConvert on stacked limbs)
# ---------------------------------------------------------------------------

def _round_limb(x: torch.Tensor, from_frac: int,
                fmt: QFormat) -> torch.Tensor:
    """Rounding stage (reference fracConvert, QuBLAS.h:2002-2204) on
    stacked limbs.  The caller sizes ``x`` so the value, the shifted value
    and (for RND modes) the 2^(d-1) tie threshold all fit the limb
    count."""
    mode = fmt.round_mode
    d = from_frac - fmt.frac_bits
    if d <= 0:
        return lshl(x, -d) if d else x
    K = x.shape[0]
    assert d < 32 * K, "working limb count must cover the shift"
    if mode == RoundMode.TRN_TCPL:
        return lshr(x, d)
    if mode == RoundMode.TRN_SMGN:
        neg_res = lneg(lshr(lneg(x), d))
        return lselect(lis_neg(x), neg_res, lshr(x, d))
    xh = lshr(x, d)
    xl = llow_bits(x, d)
    t = lconst(1 << (d - 1), K, x.shape[1:], x.device)
    xl_gt = llt(t, xl)
    xl_eq = leq(xl, t)
    carry = _carry_mode(mode, xl_gt, xl_gt | xl_eq, xl_eq,
                        lis_neg(x), lis_pos(x), (xh[0] & 1) == 1)
    return ladd(xh, torch.cat([carry.to(torch.int64)[None],
                               torch.zeros_like(xh[1:])]))


def _overflow_limb(y: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """intConvert (QuBLAS.h:2206-2344) on stacked limbs."""
    K = y.shape[0]
    w = fmt.storage_bits
    omode = fmt.overflow_mode
    shape = y.shape[1:]
    if omode in (OverflowMode.SAT_TCPL, OverflowMode.SAT_ZERO,
                 OverflowMode.SAT_SMGN):
        hi_b = lconst((1 << (w - 1)) - 1, K, shape, y.device)
        if not fmt.signed:
            lo_v = 0
        elif omode == OverflowMode.SAT_SMGN:
            lo_v = -(1 << (w - 1)) + 1
        else:
            lo_v = -(1 << (w - 1))
        lo_b = lconst(lo_v, K, shape, y.device)
        over = llt(hi_b, y)
        under = llt(y, lo_b)
        if omode == OverflowMode.SAT_ZERO:
            return lselect(over | under, torch.zeros_like(y), y)
        y = lselect(over, hi_b, y)
        return lselect(under, lo_b, y)
    if omode == OverflowMode.WRP_TCPL:
        wb = w if fmt.signed else w - 1  # unsigned wraps at int+frac bits
        # widths.requant_work_bits sizes K to storage_bits + 2, so the mask
        # and the -(2^wb) sign-extension addend fit the working width
        assert wb < 32 * K, "working limb count must cover the wrap width"
        m = llow_bits(y, wb) if wb else torch.zeros_like(y)
        if not fmt.signed:
            return m
        sign = (m[(wb - 1) // 32] >> ((wb - 1) % 32)) & 1
        ext = ladd(m, lconst(-(1 << wb), K, shape, y.device))
        return lselect(sign == 1, ext, m)
    if omode == OverflowMode.WRP_TCPL_SAT:
        # reference identity stub (QuBLAS.h:2336-2344): the machine-word
        # wrap is the store's truncation (widths.limb_count)
        return y
    raise AssertionError(omode)


def requantize_limb(x: torch.Tensor, from_frac: int, fmt: QFormat):
    """Bit-exact requantize of stacked limbs into ``fmt``'s storage form
    (:func:`store_limbs`)."""
    return store_limbs(_overflow_limb(_round_limb(x, from_frac, fmt), fmt),
                       fmt)


def store_limbs(y: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    """Truncate stacked limbs into ``fmt``'s storage form: an int32 tensor
    for a lane format, the int64 of pair storage, ``limb_count(fmt)``
    stacked limbs for a limb format (the value is proven to fit, or the
    format's machine-word wrap is the truncation)."""
    from .widths import limb_count, storage_kind

    kind = storage_kind(fmt)
    if kind == "lane":
        return lto_i32(y)
    if kind == "pair":
        return lto_i64(y)
    return lext(y, limb_count(fmt))
