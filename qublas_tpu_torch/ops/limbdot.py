"""Exact wide integer dots by balanced int8 digits on K1.

Port of ``qublas_tpu/ops/limbdot.py``: proof-lossless GEMM dots that
outgrow the 64-bit domain (40-bit operands with 80-bit products,
limb-storage operands, limb-storage outputs) as int8 dots on the tensor
cores:

1. **Balanced digits.**  Each operand value is written exactly as
   ``sum_i d_i * 256**i`` with digits ``d_i in [-128, 127]``, one extra
   digit absorbing the sign (:func:`balanced_digits`).  Every digit fits
   an int8 lane.
2. **One K1 launch a k-segment.**  ``dot(A, B) = sum_{i,j} 256**(i+j)
   dot(A_i, B_j)``.  A's ``da`` digit planes stacked as rows, ``[da*m,
   seg]``, times B's ``db`` planes stacked as columns, ``[seg, db*n]``
   (K-major, as K1's tensor-core route reads B), give every block
   ``dot(A_i, B_j)`` of the segment in one
   :func:`~qublas_tpu_torch.ops.fused_gemm.int_dot`.  Segments are short
   enough (:func:`_seg_len`) that each block and each per-scale sum of
   blocks fits int32.  The JAX package issues the same products as one
   batched einsum.
3. **Exact limb recombination.**  The blocks sum by scale ``s = i + j`` in
   int32, as in the JAX package; each scale's sum, shifted by ``8*s`` bits,
   splits into a low 32-bit word and a signed high part added to two int64
   limb accumulators, which a final carry pass normalizes into ``Kw``
   32-bit limbs (:mod:`.limbint`).  The accumulators hold the same sum as
   the JAX package's limb adds; every partial fits ``32*Kw`` bits by
   :func:`work_bits`.
"""

from __future__ import annotations

import torch

from . import limbint as L
from .fused_gemm import int_dot
from .widths import Interval

__all__ = ["digits_needed", "balanced_digits", "limb_axis_sum",
           "limb_dot_2d", "work_bits", "to_limbs_any", "i32_to_limbs",
           "digit_matmuls"]

# per-digit product bound: digits are in [-128, 127]
_DIGIT_PROD_MAX = 128 * 128  # 2^14
_I32_MAX = (1 << 31) - 1


def digits_needed(iv: Interval) -> int:
    """Balanced base-256 digits for every value in ``iv``: the bytes of the
    two's complement plus one digit that absorbs the sign byte and the
    final carry."""
    return -(-iv.bits // 8) + 1


def digit_matmuls(iva: Interval, ivb: Interval) -> int:
    """Number of int8 digit-pair dots a wide dot of these operands costs
    (the admission gates bound it)."""
    return digits_needed(iva) * digits_needed(ivb)


def to_limbs_any(x, K: int) -> torch.Tensor:
    """Lane tensor, pair-storage int64 or LimbArray -> sign-extended
    ``(K, ...)`` limbs."""
    if isinstance(x, L.LimbArray):
        return L.lext(x.limbs, K)
    return L.limbs_from_i64(x, K)


def i32_to_limbs(x: torch.Tensor, K: int) -> torch.Tensor:
    """Sign-extended ``(K, ...)`` limbs of an int32 tensor."""
    return L.limbs_from_i64(x, K)


def balanced_digits(x, nd: int) -> torch.Tensor:
    """Exact balanced base-256 digits of an integer tensor: int8 of shape
    ``(nd, *x.shape)`` with ``value == sum_i digits[i] * 256**i``.

    ``x`` (lanes, pair int64 or LimbArray) fits ``8 * (nd - 1)`` bits
    (``nd = digits_needed(iv)``).  With ``u_i`` the unsigned bytes of the
    value sign-extended to ``nd`` bytes, ``t = u_i + c;  d_i = t - 256*[t
    >= 128];  c' = [t >= 128]`` keeps ``sum_{i<j} d_i 256**i + c * 256**j
    == sum_{i<j} u_i 256**i``; at the sign byte a non-negative value closes
    with no carry, and a negative one drops a carry that cancels the
    ``-2**(8*nd)`` excess of the unsigned reading."""
    limbs = to_limbs_any(x, -(-nd // 4))
    c = None
    out = []
    for i in range(nd):
        u = (limbs[i // 4] >> (8 * (i % 4))) & 0xFF
        t = u if c is None else u + c
        c = (t >= 128).to(torch.int64)
        out.append(t - 256 * c)
    return torch.stack(out).to(torch.int8)


def limb_axis_sum(limbs: torch.Tensor, axis: int) -> torch.Tensor:
    """Log-depth exact limb sum over element axis ``axis`` (the stacked
    tensor's axis ``axis + 1``), zero-padded to even at each level.  Valid
    under a losslessness proof, with every partial bounded to the limb
    width by the caller."""
    ax = axis + 1 if axis >= 0 else limbs.ndim + axis
    while limbs.shape[ax] > 1:
        if limbs.shape[ax] % 2:
            pad = list(limbs.shape)
            pad[ax] = 1
            limbs = torch.cat([limbs, limbs.new_zeros(pad)], dim=ax)
        lead = (slice(None),) * ax
        limbs = L.ladd(limbs[lead + (slice(0, None, 2),)],
                       limbs[lead + (slice(1, None, 2),)])
    return limbs.select(ax, 0)


def _seg_len(k: int, gmax: int) -> int:
    """Largest k-segment such that every digit-pair segment dot and every
    per-scale sum of at most ``gmax`` of them fits int32."""
    return max(min(_I32_MAX // (_DIGIT_PROD_MAX * gmax), k), 1)


def work_bits(iva: Interval, ivb: Interval, k: int) -> int:
    """Exact working width (bits) of the limb accumulator: the dot (and, by
    subset sums, every partial), every per-scale recombination partial, and
    one bit of negation headroom."""
    from .gemm import dot_partial_interval

    da, db = digits_needed(iva), digits_needed(ivb)
    gmax = min(da, db)
    seg = _seg_len(k, gmax)
    col = seg * gmax * _DIGIT_PROD_MAX
    part = 0
    worst = 0
    for s in range(da + db - 1):
        part += col << (8 * s)
        worst = max(worst, part)
    dot_iv = dot_partial_interval(iva * ivb, k)
    return max(Interval(-worst, worst).bits, dot_iv.bits)


def _transpose(x):
    return x.transpose(0, 1) if isinstance(x, L.LimbArray) else x.t()


def limb_dot_2d(ad, bd, iva: Interval, ivb: Interval,
                Kw: int) -> torch.Tensor:
    """Exact ``(Kw, m, n)`` stacked-limb dot of ``ad`` [m, k] @ ``bd``
    [k, n].

    Operands are lane tensors, pair-storage int64 or LimbArrays whose raws
    lie in ``iva``/``ivb``; ``Kw`` covers :func:`work_bits` (the caller's
    admission gate proves it).  Valid only under a losslessness proof.  On
    CUDA tensors each k-segment is one K1 launch; on CPU tensors
    ``int_dot`` takes its plain version."""
    m, k = ad.shape
    n = bd.shape[1]
    da, db = digits_needed(iva), digits_needed(ivb)
    seg = _seg_len(k, min(da, db))
    a_dig = balanced_digits(ad, da).reshape(da * m, k)
    # B's planes K-major: [db*n, k], read by K1 as its [k, db*n] view
    b_dig = balanced_digits(_transpose(bd), db).reshape(db * n, k)
    acc = torch.zeros((Kw, m, n), dtype=torch.int64,
                      device=a_dig.device)
    for s0 in range(0, k, seg):
        dots = int_dot(a_dig[:, s0:s0 + seg], b_dig[:, s0:s0 + seg].t())
        blocks = dots.reshape(da, m, db, n)
        for s in range(da + db - 1):
            col = None
            for i in range(max(0, s - db + 1), min(da - 1, s) + 1):
                blk = blocks[i, :, s - i]
                col = blk if col is None else col + blk  # int32-exact
            # the low word at limb j, the signed rest at limb j + 1 (work_bits
            # puts every scale's lowest bit below limb Kw)
            v = col.to(torch.int64) << (8 * s % 32)
            j = 8 * s // 32
            acc[j] += v & L.M32
            if j + 1 < Kw:
                acc[j + 1] += v >> 32
    out = []
    carry = None
    for j in range(Kw):
        t = acc[j] if carry is None else acc[j] + carry
        out.append(t & L.M32)
        carry = t >> 32
    return torch.stack(out)
