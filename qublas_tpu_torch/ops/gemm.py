"""Quantized GEMM (Qgemul) on torch: the exactness proof and the dispatch.

Port of ``qublas_tpu.ops.gemm``.  The proof machinery (``_identity_range``,
``_lossless_requant``, ``ExactPlan``, ``tree_exact``,
``dot_partial_interval``, ``exact_plan``, ``_device_epilogue_ok``) is a copy
of the JAX package's pure-Python planners: the machine with the card has no
JAX, and ``qublas_tpu.ops.gemm`` imports it at module level.  The CPU tests
pin the copies to the originals.

:func:`qgemul` dispatches in the JAX package's order over the two tiers
ported so far:

1. **Lossless tier** (``exact_plan`` and ``_device_epilogue_ok``): every
   association order gives the same bits, so the dot is one int8 (or int32)
   integer GEMM with the requantize fused on its int32 accumulator —
   :func:`~qublas_tpu_torch.ops.fused_gemm.fused_int8_gemm` (kernel K1).
2. **Order-sensitive tier** (``plan_tree``): the reference's balanced tree
   with per-product and per-layer requantization —
   :func:`~qublas_tpu_torch.ops.tree_gemm.tree_gemm` (kernel K2).  The JAX
   package's prefix-lossless hybrid tier computes the same bits faster on a
   TPU; on the card K2 evaluates those configs directly.

Batched operands, the limb and pair-domain wide tiers, the streaming wide
GEMM and the host fallback raise ``NotImplementedError`` (ROADMAP items 4,
10 and 11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from qublas_tpu import hostops
from qublas_tpu.ops.widths import Interval, fmt_interval, route_requant
from qublas_tpu.qformat import OverflowMode, QFormat, add_merge, mul_merge

from ..qtensor import QTensor
from .fused_gemm import fused_int8_gemm
from .reduce import layer_format
from .tree_gemm import plan_tree, tree_gemm
from .widths import torch_dtype_for

__all__ = ["qgemul", "exact_plan", "ExactPlan", "host_qgemul"]


# ---------------------------------------------------------------------------
# Exactness proof (copy of qublas_tpu/ops/gemm.py:100-204)
# ---------------------------------------------------------------------------

def _identity_range(fmt: QFormat):
    """Raw interval on which ``int_convert`` + the store are the identity.
    WRP_TCPL_SAT's store wraps at the machine word, so its identity range is
    the signed word interval."""
    if fmt.overflow_mode == OverflowMode.WRP_TCPL_SAT:
        w = fmt.storage_bits
        word = 32 if w <= 32 else 64 if w <= 64 else 64 * ((w + 63) // 64)
        return -(1 << (word - 1)), (1 << (word - 1)) - 1
    hi = fmt.raw_max
    if not fmt.signed:
        lo = 0
    elif fmt.overflow_mode == OverflowMode.SAT_SMGN:
        lo = fmt.raw_min + 1
    else:
        lo = fmt.raw_min
    return lo, hi


def _lossless_requant(iv: Interval, from_frac: int, fmt: QFormat):
    """Interval after a provably-lossless requantize into ``fmt``; None if
    the requantize can round (frac drops) or saturate/wrap."""
    d = fmt.frac_bits - from_frac
    if d < 0:
        return None  # precision drops -> rounding may occur
    out = iv << d
    rng = _identity_range(fmt)
    if rng is not None and not (out.lo >= rng[0] and out.hi <= rng[1]):
        return None
    return out


@dataclass(frozen=True)
class ExactPlan:
    """Proof artifact: the dot is lossless, so int32 accumulation at the
    product's fractional scale + one epilogue reproduces the tree
    bit-exactly."""

    prod_frac: int        # fa.frac + fb.frac — scale of the raw dot product
    final_fmt: QFormat    # format of the tree's final value
    dot_interval: Interval  # bound on every partial sum of raw products
    prod_interval: Interval  # bound on one raw product


def tree_exact(value_iv: Interval, value_fmt: QFormat, add_formats,
               k: int) -> Optional[QFormat]:
    """Prove the tree accumulation of k per-product values lossless (every
    layer add, odd-tail pass-through conversions included, neither rounds
    nor saturates).  Returns the tree's final format, or None."""
    iv, cur_fmt, cur_frac = value_iv, value_fmt, value_fmt.frac_bits
    n, layer = k, 0
    while n > 1:
        lf = layer_format(add_formats, layer)
        if lf is None:
            lf = add_merge(cur_fmt, cur_fmt)
        pair = _lossless_requant(iv + iv, cur_frac, lf)
        if pair is None:
            return None
        if n % 2:
            tail = _lossless_requant(iv, cur_frac, lf)
            if tail is None:
                return None
            iv = Interval(min(pair.lo, tail.lo), max(pair.hi, tail.hi))
        else:
            iv = pair
        cur_fmt, cur_frac = lf, lf.frac_bits
        n = (n + 1) // 2
        layer += 1
    return cur_fmt


def dot_partial_interval(prod_iv: Interval, k: int) -> Interval:
    """Bound on every partial sum of j in 1..k products, each in prod_iv."""
    lo, hi = prod_iv.lo, prod_iv.hi
    return Interval(min(k * lo, lo), max(k * hi, hi))


def exact_plan(fa: QFormat, fb: QFormat, mul_fmt: QFormat, add_formats,
               k: int) -> Optional[ExactPlan]:
    """Prove the product-quantize + tree-accumulate pipeline lossless."""
    pf = fa.frac_bits + fb.frac_bits
    prod_iv = fmt_interval(fa) * fmt_interval(fb)
    iv = _lossless_requant(prod_iv, pf, mul_fmt)
    if iv is None:
        return None
    final_fmt = tree_exact(iv, mul_fmt, add_formats, k)
    if final_fmt is None:
        return None
    return ExactPlan(pf, final_fmt, dot_partial_interval(prod_iv, k),
                     prod_iv)


def _device_epilogue_ok(plan: ExactPlan, out_fmt: QFormat) -> bool:
    """Copy of qublas_tpu/ops/gemm.py:729-734: the int32 dot and its
    requantize into ``out_fmt`` both stay on int32 lanes."""
    if torch_dtype_for(out_fmt) is None:
        return False
    if not plan.dot_interval.fits32:
        return False
    return route_requant(plan.dot_interval, plan.prod_frac, out_fmt) == "i32"


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def qgemul(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to=None,
           add_formats=(), transpose_a: bool = False,
           transpose_b: bool = False, mul_full_prec: bool = False,
           epilogue_lut=None) -> QTensor:
    """C = op(A) @ op(B) with per-product and per-layer quantization.

    Readme-parity API (``readme.md:80-87``): ``mul_to`` ~ QgemulMulArgs,
    ``add_formats`` ~ QgemulAddArgs TypeList, ``transpose_a/b`` ~
    QgemulTransposedA/B.  ``epilogue_lut`` applies a
    :class:`~qublas_tpu_torch.anus.QTable` built for ``out_fmt`` to the
    result.  Operands are 2-D lane-storage QTensors on one device; a CUDA
    operand runs the tier's kernel, a CPU operand its plain version.
    """
    if isinstance(out_fmt, QTensor):
        out_fmt = out_fmt.fmt  # readme-style call shape `Qgemul(C, A, B)`
    if epilogue_lut is not None:
        return epilogue_lut(qgemul(a, b, out_fmt, mul_to, add_formats,
                                   transpose_a, transpose_b, mul_full_prec))
    if isinstance(add_formats, QFormat):
        add_formats = (add_formats,)
    add_formats = tuple(add_formats)
    if a.ndim != 2 or b.ndim != 2:
        raise NotImplementedError(
            "batched qgemul operands are not yet ported (ROADMAP item 4)")
    if transpose_a:
        a = QTensor(a.data.t(), a.fmt)
    if transpose_b:
        b = QTensor(b.data.t(), b.fmt)
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"inner dims mismatch: {a.shape} @ {b.shape}")
    k = a.shape[-1]
    mul_fmt = mul_merge(a.fmt, b.fmt, mul_to, mul_full_prec)

    plan = exact_plan(a.fmt, b.fmt, mul_fmt, add_formats, k)
    if plan is not None and _device_epilogue_ok(plan, out_fmt):
        raw = fused_int8_gemm(a.data, b.data, plan.prod_frac, out_fmt)
        return QTensor(raw, out_fmt)
    if plan is not None:
        raise NotImplementedError(
            "lossless dot wider than int32: the limb and pair-domain wide "
            "tiers are not yet ported (ROADMAP items 10-11)")

    tplan = plan_tree(a.fmt, b.fmt, mul_fmt, add_formats, k, out_fmt)
    if tplan is None:
        raise NotImplementedError(
            "config outside the int32 tree: the streaming wide GEMM and the "
            "host fallback are not yet ported (ROADMAP items 4, 10-11)")
    return QTensor(tree_gemm(a.data, b.data, tplan, out_fmt), out_fmt)


def host_qgemul(a: QTensor, b: QTensor, out_fmt: QFormat, mul_to=None,
                add_formats=(), mul_full_prec: bool = False) -> np.ndarray:
    """Raws of the exact host golden model (``qublas_tpu.hostops.qgemul``)
    for the same call: the semantic oracle for checks, one Python-int
    product at a time, so keep the shapes small."""
    A, B = a.raw(), b.raw()
    m, k = A.shape
    n = B.shape[1]
    a_rows = [[(int(A[i, p]), a.fmt) for p in range(k)] for i in range(m)]
    b_rows = [[(int(B[p, j]), b.fmt) for j in range(n)] for p in range(k)]
    c = hostops.qgemul(a_rows, b_rows, out_fmt, mul_to, add_formats,
                       mul_full_prec=mul_full_prec)
    return np.array([[v[0] for v in row] for row in c], dtype=np.int64)
